"""Per-block costs of a dry-run cell and the oracle-driven pruning of an
install's knob space (the reference package's ``roofline/costing.py``).

The reference corrects XLA's ``cost_analysis()``, which counts each
``while``-loop body once: a unit (one block of each kind, the whisper
encoder block, the fused-CE chunk) is compiled alone, once with its chunk
loop rolled and once with two trips inlined, and the marginal trip scales
to the loop's trip count (:func:`corrected_costs` then adds
``count·total - prod_copies·once`` to the whole program's count).

The port's loops are Python loops: the layers (``models/transformer.py::
_scan_stack``), the flash kv blocks, the SSD/WKV chunks and the CE chunks
all run every trip eagerly, so a count of the whole step
(``roofline/counting.py``) is already complete and needs no correction.
:func:`unit_costs` counts one unit on the cell's mesh and returns ``total
== once``; the dry run keeps the units as a per-block-kind breakdown and
never applies :func:`corrected_costs` (it would count the loops twice).
``cfg.unroll_attn`` and ``cfg.unroll_ssm`` change nothing in the port.

:func:`cell_units` and :func:`corrected_costs` are the reference's,
verbatim: pure functions of the config, the shape and the records.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.configs.base import ModelConfig, Shape
from repro_torch.core.knobs import KnobSpace
from repro_torch.core.oracle import oracle_time

__all__ = ["cell_units", "unit_costs", "corrected_costs", "Unit",
           "prune_dominated_candidates"]

_COST_KEYS = ("flops", "bytes", "coll")


@dataclasses.dataclass
class Unit:
    kind: str                 # block kind | 'zamba_shared' | 'ce'
    count: int                # executions per step across the model
    prod_copies: int          # loop-body copies already in the full program
    loop_family: str          # 'attn' | 'ssm' | 'none'
    trips: int                # total chunk-loop trips per execution
    n_instances: int = 1      # loop instances sharing the marginal


def _ceil(a, b):
    return -(-a // b)


def _attn_trips(cfg: ModelConfig, S: int, T: int) -> int:
    nq = _ceil(S, min(cfg.attn_q_chunk, S))
    nk = _ceil(T, min(cfg.attn_k_chunk, T))
    return nq * nk


def cell_units(cfg: ModelConfig, shape: Shape) -> list[Unit]:
    S = 1 if shape.kind == "decode" else shape.seq_len
    decode = shape.kind == "decode"
    units: list[Unit] = []
    mamba_count, mamba_copies = 0, 0
    for kind, repeat in cfg.segments():
        if kind == "zamba_super":
            mamba_count += repeat * cfg.shared_attn_every
            mamba_copies += 1
            units.append(Unit("zamba_shared", repeat, 1,
                              "none" if decode else "attn",
                              0 if decode else _attn_trips(cfg, S, S)))
        elif kind == "mamba2":
            mamba_count += repeat
            mamba_copies += 1
        else:
            if kind in ("attn", "moe", "enc"):
                fam = "none" if decode else "attn"
                trips = 0 if decode else _attn_trips(cfg, S, S)
                units.append(Unit(kind, repeat, 1, fam, trips))
            elif kind == "rwkv6":
                fam = "none" if decode else "ssm"
                trips = 0 if decode else _ceil(S, cfg.rwkv_chunk)
                units.append(Unit(kind, repeat, 1, fam, trips))
            elif kind == "dec_cross":
                fam = "none" if decode else "attn"
                trips = (0 if decode else
                         _attn_trips(cfg, S, S) +
                         _attn_trips(cfg, S, cfg.enc_seq))
                units.append(Unit(kind, repeat, 1, fam, trips,
                                  n_instances=1 if decode else 2))
            else:
                raise ValueError(kind)
    if mamba_count:
        fam = "none" if decode else "ssm"
        trips = 0 if decode else _ceil(S, cfg.ssm_chunk)
        units.append(Unit("mamba2", mamba_count, mamba_copies, fam, trips))
    if cfg.family == "audio" and not decode:
        units.append(Unit("enc", cfg.n_enc_layers, 1, "attn",
                          _attn_trips(cfg, cfg.enc_seq, cfg.enc_seq)))
    if shape.kind == "train" and cfg.ce_chunk:
        units.append(Unit("ce", _ceil(shape.seq_len, cfg.ce_chunk), 1,
                          "none", 0))
    return units


# ---------------------------------------------------------------------------
# unit cost
# ---------------------------------------------------------------------------

def _first_layer(model, kind: str) -> int:
    return next(i for i, blk in enumerate(model.layers) if blk.kind == kind)


def _cache_at(cache, length: int):
    """A layer's cache (dicts, lists) with its ``len`` set to ``length``;
    the tensors shared."""
    if isinstance(cache, dict):
        return {k: (length if k == "len" else _cache_at(v, length))
                for k, v in cache.items()}
    if isinstance(cache, list):
        return [_cache_at(v, length) for v in cache]
    return cache


def unit_costs(cfg: ModelConfig, unit: Unit, shape: Shape, mesh, rules,
               params, caches, *, device="cpu") -> dict:
    """``{"once": cost, "total": cost}``, each ``{flops, bytes, coll,
    count_s}``, of one execution of ``unit`` on ``mesh``: the first block
    of its kind in ``params`` (the cell's model, fake DTensors) on an
    activation laid out as the blocks' input, forward and, for a train
    shape, backward through the block recomputed (the reference's
    ``jax.grad(jax.checkpoint(f))``); for a prefill or decode shape the
    block writes into its layer's cache of ``caches``.  Called under the
    cell's ``FakeTensorMode``.  The port's chunk loops run every trip, so
    ``total`` is ``once``."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.layers import (Ctx, chunked_cross_entropy,
                                           linear, torch_dtype)
    from repro_torch.models.sharding import logical_spec
    from .counting import count_step, fake_dtensor

    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    train = shape.kind == "train"
    start = shape.seq_len - 1 if shape.kind == "decode" else 0
    ctx = Ctx(cfg, None, mesh, rules)
    dtype = torch_dtype(cfg.compute_dtype)

    def act(seq, grad=train, names=("batch", "seq", "embed")):
        dims = (B, seq, cfg.d_model)
        spec = logical_spec(rules, mesh, names, dims=dims)
        return fake_dtensor(dims, dtype, mesh, spec, device,
                            requires_grad=grad)

    def run(f, *args):
        if not train:
            with torch.no_grad():
                return f(*args)
        out = checkpoint(f, *args, use_reentrant=False)
        out.float().sum().backward()
        params.zero_grad(set_to_none=True)
        return None

    if unit.kind == "ce":
        Sx = min(cfg.ce_chunk, shape.seq_len)
        wshape = (cfg.d_model, cfg.vocab)
        # the head as loss_fn hands it to the CE: its FSDP shards gathered
        w = fake_dtensor(wshape, dtype, mesh, logical_spec(
            rules, mesh, (None, "vocab"), dims=wshape), device,
            requires_grad=train)
        lbl = fake_dtensor((B, Sx), torch.int64, mesh, logical_spec(
            rules, mesh, ("batch", None), dims=(B, Sx)), device)

        def fn(x, w):
            return chunked_cross_entropy(x, w, lbl, chunk=Sx)
        # laid out as loss_fn lays out the CE's input: whole sequences
        args = (act(Sx, names=("batch", None, "embed")), w)
    elif unit.kind == "zamba_shared":
        i = _first_layer(params, "zamba_super")
        cc = (None if caches is None
              else _cache_at(caches[i]["attn"], start))
        in_proj = params.layers[i].in_proj

        def fn(x):
            u = linear(in_proj, torch.cat([x, x], dim=-1), ctx)
            return params.shared_attn(u, ctx, cc)[0]
        args = (act(S),)
    else:
        enc = None
        if unit.kind == "enc":
            block, cc, Sx = params.encoder.blocks[0], None, cfg.enc_seq
        elif unit.kind == "mamba2" and params.shared_attn is not None:
            i = _first_layer(params, "zamba_super")
            block, Sx = params.layers[i].mamba[0], S
            cc = None if caches is None else caches[i]["mamba"][0]
        else:
            i = _first_layer(params, unit.kind)
            block, Sx = params.layers[i], S
            cc = None if caches is None else _cache_at(caches[i], start)
        if unit.kind == "dec_cross":
            enc = act(cfg.enc_seq, grad=False)

        def fn(x):
            if unit.kind == "dec_cross":
                return block(x, ctx, cc, enc_out=enc)
            out = block(x, ctx, cc)
            return out[0] if isinstance(out, tuple) else out
        args = (act(Sx),)

    t0 = time.perf_counter()
    got = count_step(run, fn, *args)
    once = {"flops": float(got["flops"]), "bytes": float(got["bytes"]),
            "coll": float(got["coll"]["total_operand_bytes"]),
            "count_s": time.perf_counter() - t0}
    return {"once": once, "total": dict(once)}


def prune_dominated_candidates(op: str, space: KnobSpace, dims_list,
                               *, dtype_bytes: int = 4,
                               slack: float = 0.15) -> KnobSpace:
    """Drop knob candidates the analytic oracle proves dominated at every
    harvested call site.

    For each dims in ``dims_list`` (e.g. the dims of
    ``roofline.harvest.harvest_decision_keys``), score every candidate with
    the deterministic H100 oracle and keep the union of all candidates
    within ``(1 + slack)`` of that dims' best.  A candidate outside the band
    at *every* site cannot win under any model whose error is below the
    slack, so the install need not time it.  Returns a new
    :class:`~repro_torch.core.knobs.KnobSpace` under the same name with the
    same parallelism function (never empty: each site contributes at least
    its argmin).
    """
    dims_list = [tuple(d) for d in dims_list]
    if not dims_list:
        return space
    keep: set[int] = set()
    for dims in dims_list:
        times = np.array([oracle_time(op, dims, c, dtype_bytes=dtype_bytes)
                          for c in space.candidates])
        band = times.min() * (1.0 + slack)
        keep.update(int(i) for i in np.flatnonzero(times <= band))
    cands = [space.candidates[i].dict for i in sorted(keep)]
    return KnobSpace(space.name, cands,
                     parallelism_fn=space._parallelism_fn)


def corrected_costs(prod: dict, unit_records: list[dict]) -> dict:
    """prod: {"flops","bytes","coll"}; records carry Unit + costs."""
    out = {k: prod[k] for k in _COST_KEYS}
    for rec in unit_records:
        u: Unit = rec["unit"]
        for k in _COST_KEYS:
            out[k] += u.count * rec["total"][k] - \
                u.prod_copies * rec["once"][k]
    return out
