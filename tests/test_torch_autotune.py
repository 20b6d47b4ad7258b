"""The fused-ingest launch autotuner, on the CPU.

The sweep's timing needs the card, but its bookkeeping does not: the
store round-trips, the geometry key follows the shape the kernel's plan
takes, a candidate whose result differs from the numpy oracle is never
chosen (its fold corrupted here through a monkeypatch, with a timer that
would make it the fastest), and ``autotune_fused`` refuses an engine off
the GPU, as the kernels have no interpret mode.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.engine import autotune  # noqa: E402
from repro_torch.engine import backends as tbe  # noqa: E402
from repro_torch.engine import plan as tplan  # noqa: E402
from repro_torch.kernels import fused_ingest as tfk  # noqa: E402
from tests.test_torch_kernels import carry_tree  # noqa: E402
from tests.test_torch_sharded import _case  # noqa: E402

GRID = [("shared", 8, 132), ("shared", 32, 264), ("global", 4, 0),
        ("global", 16, 0)]


@pytest.fixture
def store(tmp_path, monkeypatch):
    path = tmp_path / "autotune_cuda.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_STORE", str(path))
    return path


def test_store_round_trips(store):
    assert autotune.store_path() == store
    assert autotune.lookup("cuda", "L1-d1-cw1-aw1-cc0-a0") is None
    cfg = autotune.LaunchConfig("shared", 24, 264, ms=0.125,
                                records_per_s=8.0e9)
    autotune.record("cuda", "L1-d1-cw1-aw1-cc0-a0", cfg)
    other = autotune.LaunchConfig("global", 8, 0)
    autotune.record("cuda", "L2-d1-cw1-aw1-cc0-a0", other)
    assert autotune.lookup("cuda", "L1-d1-cw1-aw1-cc0-a0") == cfg
    assert autotune.lookup("cuda", "L2-d1-cw1-aw1-cc0-a0") == other
    assert cfg.launch == ("shared", 24, 264)
    assert sorted(json.loads(store.read_text())) == [
        "cuda:L1-d1-cw1-aw1-cc0-a0", "cuda:L2-d1-cw1-aw1-cc0-a0"]


def test_geometry_key_is_the_plan_shape():
    keys = {}
    for seed in range(6):
        frozen, _, _ = _case(seed)
        tree = carry_tree(frozen)
        ops = tplan.pack_route_constants(tree)
        shape = tfk.plan_shape(ops)
        key = autotune.geometry_key(tree)
        assert key == "L{}-d{}-cw{}-aw{}-cc{}-a{}".format(*shape)
        keys.setdefault(shape, set()).add(key)
    # trees whose plans differ get different keys, and equal plans one key
    assert all(len(v) == 1 for v in keys.values())
    assert len({k for v in keys.values() for k in v}) == len(keys) > 1


def test_autotune_fused_refuses_a_cpu_engine(store):
    frozen, records, _ = _case(0)
    tree = carry_tree(frozen)
    with pytest.raises(RuntimeError, match="no interpret mode"):
        autotune.autotune_fused(tree, records,
                                engine=LayoutEngine(tree, device="cpu"))
    assert not store.exists()


@pytest.mark.parametrize("corrupt", ["bids", "partial"])
def test_a_corrupted_candidate_is_never_chosen(store, monkeypatch, corrupt):
    frozen, records, _ = _case(8)
    tree = carry_tree(frozen)
    engine = LayoutEngine(tree, device="cpu")
    bad = GRID[2]
    last = []
    fold, partial = tbe.DeviceAccumulator.fold, tbe.DeviceAccumulator.partial

    def bad_fold(self, recs, return_bids=False, on_device=False):
        last.append(self.launch)
        out = fold(self, recs, return_bids, on_device)
        if corrupt == "bids" and self.launch == bad and out is not None:
            out = out.copy()
            out[len(out) // 2] ^= 1
        return out

    def bad_partial(self):
        p = partial(self)
        if corrupt == "partial" and self.launch == bad:
            p.counts = p.counts.copy()
            p.counts[0] += 1
        return p

    monkeypatch.setattr(tbe.DeviceAccumulator, "fold", bad_fold)
    monkeypatch.setattr(tbe.DeviceAccumulator, "partial", bad_partial)

    def timer(fn, reps):  # the corrupted candidate would be the fastest
        fn()
        return 0.001 if last[-1] == bad else 1.0 + len(last)

    out = autotune.sweep(engine, records, GRID, reps=1, persist=True,
                         timer=timer)
    rows = {(r["variant"], r["warps"], r["max_blocks"]): r
            for r in out["rows"]}
    assert rows[bad]["status"] == "invalid" and not rows[bad]["valid"]
    assert "ms" not in rows[bad]
    assert all(r["status"] == "ok" for k, r in rows.items() if k != bad)
    chosen = autotune.LaunchConfig.from_dict(out["chosen"])
    assert chosen.launch != bad and chosen.launch == GRID[0]
    assert autotune.lookup("cuda", out["geometry"]) == chosen
    assert out["geometry"] == autotune.geometry_key(tree)


def test_a_sweep_with_no_valid_candidate_raises(store, monkeypatch):
    frozen, records, _ = _case(8)
    engine = LayoutEngine(carry_tree(frozen), device="cpu")
    fold = tbe.DeviceAccumulator.fold
    monkeypatch.setattr(
        tbe.DeviceAccumulator, "fold",
        lambda self, r, return_bids=False, on_device=False:
            np.zeros(r.shape[0], np.int32) - 1 if return_bids
            else fold(self, r))
    with pytest.raises(RuntimeError, match="no candidate"):
        autotune.sweep(engine, records, GRID, reps=1, persist=True,
                       timer=lambda fn, reps: 1.0)
    assert not store.exists()  # the analytic plan is not stored instead


def test_pinned_geometry_is_checked():
    with pytest.raises(ValueError, match="variant"):
        tfk.pinned_plan(0, (1, 1, 1, 1, 0, 0), "local", 8, 1)
    with pytest.raises(ValueError, match="warps"):
        tfk.pinned_plan(0, (1, 1, 1, 1, 0, 0), "global", 33, 0)
    with pytest.raises(ValueError, match="grid cap"):
        tfk.pinned_plan(0, (1, 1, 1, 1, 0, 0), "shared", 8, 0)
    assert tfk.pinned_plan(0, (1, 1, 1, 1, 0, 0), "global", 16, 0) == (
        tfk.Plan(tfk.VARIANTS["global"], 16, 0))
