"""The port's LM serving CLI (``repro_torch.launch.serve_lm``) against the
reference's (``repro.launch.serve_lm``), on the CPU.

Both CLIs run with the same arguments; the port's gets the reference's
weights (``params_from_jax`` of ``repro``'s ``init_model`` at the same
seed, which is what the reference's CLI draws) in place of its own.  The
prompts come from the same numpy seed in both.  The greedy tokens must be
equal, except from a step where the reference's top-2 logit gap is under
``GAP_TOL``: there float32 rounding (the two packages agree to ~5e-5,
``tests/test_torch_models.py``) may pick the other token, and every later
token follows from it.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve_lm as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve_lm as tserve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

GAP_TOL = 1e-4
B, PLEN, GEN, MAX_SEQ, SEED = 2, 16, 8, 32, 0
ARGS = ["--batch", str(B), "--prompt-len", str(PLEN), "--gen", str(GEN),
        "--max-seq", str(MAX_SEQ), "--seed", str(SEED)]


def _ref_gap(cfg, params, prompts, extra, gen_row_prefix, row):
    """The reference's top-2 logit gap for ``row`` after its prompt and
    the generated tokens before the diverging one."""
    tokens = np.concatenate([prompts, gen_row_prefix], axis=1)
    batch = {"tokens": jnp.asarray(tokens), **extra}
    logits, _ = jmodel.prefill(params, batch, cfg)
    top2 = np.sort(np.asarray(logits[row], np.float32))[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_greedy_tokens_equal_the_reference_cli(arch, monkeypatch, capsys):
    argv = ["--arch", arch, *ARGS]
    cfg = jconfigs.get_config(arch).reduced(max_positions=MAX_SEQ)
    jp, _ = jmodel.init_model(jax.random.PRNGKey(SEED), cfg)
    want = np.asarray(jserve.main(argv))

    tcfg = configs.get_config(arch).reduced(max_positions=MAX_SEQ)
    carried = tmodel.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    monkeypatch.setattr(tmodel, "init_model", lambda gen, c: (carried, {}))
    got = tserve.main([*argv, "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["in_vocab"]
    assert got.shape == want.shape == (B, GEN)

    prompts = tserve.make_batch(tcfg, B, PLEN, SEED, "cpu")
    extra = {k: jnp.asarray(v.numpy()) for k, v in prompts.items()
             if k != "tokens"}
    for row in range(got.shape[0]):
        diff = np.flatnonzero(got[row] != want[row])
        if diff.size:  # a near tie at the first diverging step
            i = int(diff[0])
            gap = _ref_gap(cfg, jp, prompts["tokens"].numpy(), extra,
                           want[:, :i], row)
            assert gap < GAP_TOL, (row, i, gap)


def test_cli_defaults_on_the_cpu(capsys):
    """At the reference's defaults: 4 prompts of 64, 32 tokens each."""
    gen = tserve.main(["--device", "cpu"])
    assert gen.shape == (4, 32) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < 256)).all()
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == "qwen1.5-32b-smoke"
    assert summary["tokens_shape"] == [4, 32]


def test_cli_refuses_a_cache_too_short_and_a_missing_gpu():
    with pytest.raises(ValueError, match="exceed the cache"):
        tserve.main(["--device", "cpu", "--prompt-len", "16", "--gen", "20",
                     "--max-seq", "32"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--gen", "2"])
