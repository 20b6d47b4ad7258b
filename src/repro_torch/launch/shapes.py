"""Per-cell (arch × input-shape) abstract inputs and steps, as the
reference's ``repro.launch.shapes``.

``build_cell`` returns what the dry-run needs to run a cell: the step
function, its abstract arguments (``meta`` tensors), their fitted
shardings (``specs.NamedSharding``) and the reference's donation indices.
Shapes run:

  train_4k     → train_step (fwd+bwd+AdamW)
  prefill_32k  → serve_prefill (forward + cache emission)
  decode_32k   → serve_step (one token against a seq_len KV cache)
  long_500k    → serve_step, batch=1, sequence-sharded caches

The port compiles nothing: ``trace_cell`` (the counterpart of the
reference's ``lower_cell``) runs the step once on DTensors laid out by the
cell's shardings under its mesh and rules.  The dry-run calls it on fake
tensors over a fake process group (``launch/dryrun.py``).  Two things
differ from the reference: ``donate`` is kept as a record only (the port
updates the state and caches in place), and decode's ``pos`` is the
Python int ``seq_len - 1``, so that the step reads the whole cache.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig
from repro_torch.models import encdec, model
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import (LONG_CONTEXT_OVERRIDES, Rules,
                                        fitted_shardings, use_mesh)
from repro_torch.train import steps
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.schedule import ScheduleConfig

IS_AXES = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x
)


def rules_for_shape(shape: InputShape) -> Rules:
    if shape.name == "long_500k":
        over = dict(LONG_CONTEXT_OVERRIDES)
        over["seq_sp"] = None  # decode: S=1, nothing to sequence-shard
        return Rules.make(over)
    if shape.kind == "decode":
        # decode caches shard their sequence dim over `model` — robust to
        # any kv-head count (GQA kv heads rarely divide a 16-way TP axis)
        return Rules.make({"seq_sp": None, "cache_seq": ("model",)})
    return Rules.make()


def shaped_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Bind shape-dependent knobs (learned-pos table size)."""
    if cfg.pos_embed == "learned" and cfg.max_positions < shape.seq_len:
        cfg = dataclasses.replace(cfg, max_positions=shape.seq_len)
    return cfg


# ---------------------------------------------------------------------------
# abstract batches
# ---------------------------------------------------------------------------
def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_abstract(cfg: ModelConfig, shape: InputShape):
    b, s = shape.global_batch, shape.seq_len
    sds = {"tokens": _meta((b, s), torch.int32),
           "labels": _meta((b, s), torch.int32)}
    spc = {"tokens": ("batch", None), "labels": ("batch", None)}
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if cfg.n_image_patches:
        sds["patches"] = _meta((b, cfg.n_image_patches, cfg.d_model), dt)
        spc["patches"] = ("batch", None, "embed")
    if cfg.is_encdec:
        sds["frames"] = _meta((b, encdec.N_FRAMES, cfg.d_model), dt)
        spc["frames"] = ("batch", None, "embed")
    return sds, spc


def prefill_batch_abstract(cfg: ModelConfig, shape: InputShape):
    sds, spc = train_batch_abstract(cfg, shape)
    sds.pop("labels")
    spc.pop("labels")
    return sds, spc


def caches_abstract(cfg: ModelConfig, batch: int, max_seq: int):
    return model.init_caches(cfg, batch, max_seq, device="meta")


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    arch: str
    shape: InputShape
    cfg: ModelConfig
    rules: Rules
    step_name: str  # train_step | serve_prefill | serve_step
    fn: object
    args: tuple  # meta tensors (and decode's int pos)
    in_shardings: tuple
    out_shardings: object
    donate: tuple  # the reference's; the port updates in place


def build_cell(
    cfg: ModelConfig,
    shape_name: str,
    mesh,
    ocfg: AdamWConfig | None = None,
    scfg: ScheduleConfig | None = None,
    rules: Rules | None = None,
) -> Cell:
    shape = SHAPES[shape_name]
    cfg = shaped_config(cfg, shape)
    rules = rules or rules_for_shape(shape)
    ocfg = ocfg or AdamWConfig(eight_bit=cfg.opt_8bit)
    scfg = scfg or ScheduleConfig()

    if shape.kind == "train":
        state_shapes, state_specs = steps.abstract_state(cfg, ocfg)
        batch_sds, batch_specs = train_batch_abstract(cfg, shape)
        fn = functools.partial(
            steps.train_step, cfg=cfg, ocfg=ocfg, scfg=scfg
        )
        state_sh = fitted_shardings(state_shapes, state_specs, mesh, rules)
        batch_sh = fitted_shardings(batch_sds, batch_specs, mesh, rules)
        return Cell(
            arch=cfg.name, shape=shape, cfg=cfg, rules=rules,
            step_name="train_step", fn=fn,
            args=(state_shapes, batch_sds),
            in_shardings=(state_sh, batch_sh),
            out_shardings=(state_sh, None),
            donate=(0,),
        )

    # params only (no optimizer) for serving cells
    param_shapes, param_specs = model.init_model(steps._MetaGenerator(), cfg)
    param_sh = fitted_shardings(param_shapes, param_specs, mesh, rules)

    if shape.kind == "prefill":
        batch_sds, batch_specs = prefill_batch_abstract(cfg, shape)
        batch_sh = fitted_shardings(batch_sds, batch_specs, mesh, rules)
        fn = functools.partial(steps.serve_prefill, cfg=cfg)
        return Cell(
            arch=cfg.name, shape=shape, cfg=cfg, rules=rules,
            step_name="serve_prefill", fn=fn,
            args=(param_shapes, batch_sds),
            in_shardings=(param_sh, batch_sh),
            out_shardings=None,
            donate=(),
        )

    # decode: one token against a seq_len cache
    b = shape.global_batch
    cache_sds, cache_specs = caches_abstract(cfg, b, shape.seq_len)
    cache_sh = fitted_shardings(cache_sds, cache_specs, mesh, rules)
    token_sds = _meta((b, 1), torch.int32)
    token_sh = fitted_shardings(
        {"t": token_sds}, {"t": ("batch", None)}, mesh, rules
    )["t"]
    fn = functools.partial(steps.serve_step, cfg=cfg)
    return Cell(
        arch=cfg.name, shape=shape, cfg=cfg, rules=rules,
        step_name="serve_step", fn=fn,
        args=(param_shapes, cache_sds, token_sds, shape.seq_len - 1),
        in_shardings=(param_sh, cache_sh, token_sh, None),
        out_shardings=(token_sh, None, cache_sh),
        donate=(1,),
    )


def place_args(cell: Cell, device) -> tuple:
    """The cell's arguments as tensors on ``device`` laid out by its
    shardings: DTensors whose shards are fresh zeroed tensors of
    the local shape (fake ones under ``FakeTensorMode``); a 0-d leaf stays
    a plain tensor, decode's ``pos`` an int."""
    def leaf(t, sharding):
        local = _local_shape(tuple(t.shape), sharding)
        x = torch.zeros(local, dtype=t.dtype, device=device)
        return x if t.dim() == 0 else sh.from_local(
            x, sharding.spec, sharding.mesh)

    return tuple(
        a if s is None else sh.tree_map_specs(leaf, a, s)
        for a, s in zip(cell.args, cell.in_shardings))


def _local_shape(shape: tuple, sharding) -> tuple:
    sizes = sh.axis_sizes(sharding.mesh)
    out = list(shape)
    for d, part in enumerate(sharding.spec):
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is not None:
                out[d] //= sizes[a]
    return tuple(out)


def trace_cell(cell: Cell, mesh, args: tuple):
    """Run the cell's step once on ``args`` (``place_args``) under its
    mesh and rules; → the step's outputs.  Nothing is compiled.  A train
    step runs as ``steps.jit_train_step`` runs it (plain tensors join
    DTensors as replicated)."""
    if cell.step_name == "train_step":
        with use_mesh(mesh, cell.rules), steps.implicit_replication():
            return cell.fn(*args)
    with use_mesh(mesh, cell.rules):
        return cell.fn(*args)
