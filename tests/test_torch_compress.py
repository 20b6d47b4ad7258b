"""The port's int8 error-feedback pod compression
(``repro_torch.train.compress`` and the compressed train step) against
``repro.train.compress``, on the CPU.

``_quant`` equals the reference's codes and scales exactly; one
``_sync_leaf`` over 2 pods (gloo ranks of a (2 pod, 2 data, 2 model)
mesh, ``tests/_torch_ranks.py``) equals the reference's (``jax.vmap``
over a ``pod`` axis) within 1e-6, its leaves plain and as DTensors with
the row split over ``model``; 10 compressed steps on that mesh track
the plain run within 0.15 (the reference's bound); the wire bytes equal
the reference's count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import compress as tcompress  # noqa: E402

from tests import _torch_ranks as ranks  # noqa: E402

RANKS_TIMEOUT_S = 240
STEPS = 10
TRACK_ATOL = 0.15  # the reference's bound (tests/test_sharding.py)
SYNC_ATOL = 1e-6
# (pods, *shape) grads and residuals of the sync cases: a matrix, a
# stacked 3-D leaf, a vector, a scalar
SYNC_SHAPES = {"matrix": (6, 40), "stacked": (3, 4, 16), "vector": (32,),
               "scalar": ()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(7, 33), (2, 3, 64), (5,)])
def test_quant_equals_the_reference(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(
        np.float32)
    x.flat[0] = 0.0
    q, s = tcompress._quant(torch.from_numpy(x))
    jq, js = jcompress._quant(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "mamba2-780m",
                                  "whisper-small"])
def test_compressed_wire_bytes_equals_the_reference(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    jparams, _ = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     get_config(arch).reduced(), "cpu")
    assert (tcompress.compressed_wire_bytes(tparams)
            == jcompress.compressed_wire_bytes(jparams))


def test_error_state_is_f32_zeros_shaped_as_the_params():
    cfg = get_config("qwen1.5-32b").reduced()
    params, _ = tmodel.init_model(
        torch.Generator().manual_seed(0), cfg)
    err = tcompress.init_error_state(params)
    for p, e in zip(tmodel.leaves(params), tmodel.leaves(err)):
        assert e.shape == p.shape and e.dtype == torch.float32
        assert not e.any()


def _sync_inputs():
    rng = np.random.default_rng(3)
    out = {}
    for name, shape in SYNC_SHAPES.items():
        g = rng.standard_normal((2,) + shape).astype(np.float32)
        e = (0.01 * rng.standard_normal((2,) + shape)).astype(np.float32)
        out[name] = (g, e)
    return out


@pytest.fixture(scope="module")
def compress_ranks(tmp_path_factory):
    leaves = _sync_inputs()
    got = ranks.run_ranks(ranks.compress_ranks, 8,
                          tmp_path_factory.mktemp("compress"),
                          RANKS_TIMEOUT_S, leaves_np=leaves, n_steps=STEPS)
    return got, leaves


def test_sync_leaf_over_two_pods_equals_the_reference(compress_ranks):
    """Each rank's synced grad and residual against the reference's
    ``_sync_leaf`` under ``jax.vmap`` over a 2-pod axis; with the leaf a
    DTensor whose rows are split over ``model``, the row scale is the
    whole row's, so the result is the same."""
    got, leaves = compress_ranks
    for name, (g, e) in leaves.items():
        sync = jax.vmap(lambda a, b: jcompress._sync_leaf(a, b, 2),
                        axis_name="pod")
        want_g, want_e = (np.asarray(t) for t in sync(g, e))
        for r in got:
            pod = r["pod"]
            for key in ("sync", "sync_dtensor"):
                if name not in r[key]:
                    continue
                out_g, out_e = r[key][name]
                np.testing.assert_allclose(out_g, want_g[pod], rtol=0,
                                           atol=SYNC_ATOL)
                np.testing.assert_allclose(out_e, want_e[pod], rtol=0,
                                           atol=SYNC_ATOL)
    assert all(name in r["sync_dtensor"] for r in got
               for name in ("matrix", "stacked"))


def test_compressed_steps_track_the_plain_run(compress_ranks):
    """10 steps on (2 pod, 2 data, 2 model), plain and compressed, from
    one state on the same batches: the compressed loss falls and ends
    within 0.15 of the plain one; every rank reports the same losses."""
    got, _ = compress_ranks
    plain, comp = got[0]["plain"], got[0]["compressed"]
    assert len(comp) == STEPS and np.isfinite(comp).all()
    assert comp[-1] < comp[0]
    assert abs(comp[-1] - plain[-1]) < TRACK_ATOL
    for r in got[1:]:
        assert r["plain"] == plain and r["compressed"] == comp
