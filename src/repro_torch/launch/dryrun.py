"""Multi-pod dry run: the sharded step of a production cell, counted on a
fake world (the reference package's ``launch/dryrun.py``).

For every (architecture x input shape x mesh) cell this traces the real
step (train: ``loss_fn``, backward and ``adamw_update``; prefill; decode:
one token against a ``seq_len`` cache) on the production mesh, 16x16
single-pod or 2x16x16 multi-pod, and records what rank 0 of that mesh
would hold and do: its memory, its FLOPs and bytes (the reference's
``memory_analysis()`` and ``cost_analysis()``), its collectives, and the
three-term roofline on the H100 (``roofline/analysis.py``).

A cell starts a world of 256 or 512 ranks in this one process
(``torch.distributed``'s ``fake`` backend: a collective returns at once,
moving nothing), the counterpart of the reference's
``--xla_force_host_platform_device_count``, builds the mesh, makes the
parameters, optimiser state, caches and batch fake DTensors (each rank's
shard of its spec, under ``FakeTensorMode``) and runs the step once under
the per-rank counter (``roofline/counting.py``).  Nothing is allocated
and no kernel is launched; the world is torn down after the cell.  The
mesh path never routes a GEMM (``Ctx.routes_gemm`` is False under a
mesh), as the reference's does not.

``--device cuda`` (the default) gives the mesh, the fake tensors and so
the collectives (DTensor's all-to-all) the card's; it raises on a host
without one.  ``--device cpu`` is for the CPU tests: DTensor on a CPU
mesh falls back from all-to-all to all-gather and chunk, so such a cell
counts other collectives than the card's would.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single --out runs/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The record keeps the reference's keys, with ``trace_s`` (the cell's
build, trace and count) in place of ``lower_s`` and ``compile_s``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (ALIASES, ARCHITECTURES, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.optim import AdamWConfig
from repro_torch.roofline.counting import fake_dtensor

__all__ = ["fake_world", "fake_mode", "argument_bytes", "build_step",
           "run_cell", "main"]


@contextlib.contextmanager
def fake_mode():
    """The ``FakeTensorMode`` a dry step runs under, with the models'
    per-device cache (RoPE's frequencies, ``layers._rope_freqs``) emptied
    on the way in and out: no real tensor a real step cached enters the
    trace, and no fake one made in it outlives it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import layers
    layers._rope_freqs.cache_clear()
    try:
        with FakeTensorMode(allow_non_fake_inputs=False):
            yield
    finally:
        layers._rope_freqs.cache_clear()


def _active_params(cfg) -> int:
    """Approximate parameter count (active params for MoE)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hd = cfg.hd()
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        per = 4 * d * d + 2 * d * cfg.d_ff + d * d
    elif cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        per = 2 * d * d_in + d_in * d          # mamba proj in/out
    else:
        attn = d * cfg.n_heads * hd + 2 * d * cfg.kv_heads * hd + \
            cfg.n_heads * hd * d
        if cfg.use_mla:
            attn = (d * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                    + d * (cfg.kv_lora + cfg.qk_rope_dim)
                    + cfg.kv_lora * cfg.n_heads *
                    (cfg.qk_nope_dim + cfg.v_head_dim)
                    + cfg.n_heads * cfg.v_head_dim * d)
        if cfg.n_experts:
            ff = 3 * d * (cfg.moe_d_ff or cfg.d_ff) * \
                (cfg.top_k + cfg.n_shared_experts)
        else:
            ff = (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.d_ff
        per = attn + ff
    total = emb + L * per
    if cfg.family == "audio":
        total += cfg.n_enc_layers * (4 * d * d + 2 * d * cfg.d_ff)
    return int(total)


# ---------------------------------------------------------------------------
# the fake world and fake DTensors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """A ``torch.distributed`` world of ``size`` ranks in this process,
    this process rank 0, over the ``fake`` backend; raises if the process
    already has a world, and destroys its own on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake world; this "
                           "process already has a torch.distributed world")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(a, mesh, device, dtype=None, requires_grad=False):
    """An :class:`~repro_torch.models.sharding.AbstractTensor` as a fake
    DTensor (in ``dtype`` if given)."""
    return fake_dtensor(a.shape, dtype or a.dtype, mesh, a.spec, device,
                        requires_grad=requires_grad)


def _fake_tree(tree, mesh, device, length: int):
    """The abstract caches' tree as fake DTensors, every ``len`` set to
    ``length``."""
    from repro_torch.models.sharding import AbstractTensor
    if isinstance(tree, AbstractTensor):
        return _fake(tree, mesh, device)
    if isinstance(tree, dict):
        return {k: (length if k == "len" else
                    _fake_tree(v, mesh, device, length))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake_tree(v, mesh, device, length) for v in tree]
    return tree


def _fake_model(cfg, aparams, mesh, device, *, dtype=None,
                requires_grad: bool):
    """The model on the ``meta`` device with each parameter replaced by a
    fake DTensor of its spec (in ``dtype`` where it is float32, if
    given)."""
    from repro_torch.models.transformer import Transformer
    model = Transformer(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod) if mod else model
        want = dtype if dtype is not None and p.dtype == torch.float32 \
            else p.dtype
        setattr(owner, leaf, torch.nn.Parameter(
            _fake(aparams[name], mesh, device, want),
            requires_grad=requires_grad))
    return model


def _shard_bytes(a, mesh, dtype=None) -> int:
    """Rank 0's bytes of an :class:`~repro_torch.models.sharding.
    AbstractTensor` (each dim cut by its spec entry's axes, as DTensor
    cuts it: the first shard takes the ceiling)."""
    from repro_torch.models.sharding import mesh_axis_size
    n = 1
    for d, entry in zip(a.shape, tuple(a.spec) + (None,) * a.ndim):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n *= -(-d // mesh_axis_size(mesh, axes))
    return n * (dtype or a.dtype).itemsize


def argument_bytes(cfg, shape, mesh, rules) -> int:
    """Rank 0's bytes of the cell's step inputs, from their specs alone (a
    ``DeviceMesh`` or an :class:`~repro_torch.models.sharding.
    AbstractMesh`; no world): the parameters (in ``compute_dtype`` for
    serving), the AdamW state for a train step, the caches for serving,
    and the batch.  What :func:`run_cell` records as ``argument_bytes``."""
    from repro_torch.launch.specs import (abstract_caches, abstract_params,
                                          abstract_train_state, input_specs)
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.sharding import AbstractTensor
    total = sum(_shard_bytes(a, mesh)
                for a in input_specs(cfg, shape, mesh).values())
    if shape.kind == "train":
        aparams, astate, _ = abstract_train_state(cfg, rules, mesh)
        leaves = [*aparams.values(), astate.step, *astate.mu.values(),
                  *astate.nu.values()]
        return total + sum(_shard_bytes(a, mesh) for a in leaves)
    aparams, _ = abstract_params(cfg, rules, mesh)
    serve = torch_dtype(cfg.compute_dtype)
    total += sum(_shard_bytes(a, mesh, serve if a.dtype == torch.float32
                              else None) for a in aparams.values())
    acaches, _ = abstract_caches(cfg, shape.global_batch, shape.seq_len,
                                 rules, mesh)

    def caches(tree):
        if isinstance(tree, AbstractTensor):
            return _shard_bytes(tree, mesh)
        if isinstance(tree, dict):
            return sum(caches(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(caches(v) for v in tree)
        return 0
    return total + caches(acaches)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def build_step(cfg, shape, mesh, rules, *, device="cuda",
               adamw=AdamWConfig(), grad_compression: bool = False):
    """``(fn, args)``: the cell's step and its inputs as fake DTensors
    (call under the cell's ``FakeTensorMode``).  Train: ``loss_fn``,
    backward, each gradient brought to its parameter's placements (the
    data-parallel reduce), the optional int8 round trip and
    ``adamw_update``, as ``TrainLoop.step_fn``.  Serving deploys the
    weights in ``compute_dtype`` with no optimiser state, as the
    reference's dry run does."""
    from repro_torch.launch.specs import (abstract_caches, abstract_params,
                                          abstract_train_state, input_specs)
    from repro_torch.models import decode_step, loss_fn, prefill
    from repro_torch.models.layers import torch_dtype
    from repro_torch.optim import (AdamWState, adamw_update,
                                   compress_decompress, init_error_feedback)

    batch = {k: _fake(a, mesh, device)
             for k, a in input_specs(cfg, shape, mesh).items()}

    if shape.kind == "train":
        aparams, astate, _ = abstract_train_state(cfg, rules, mesh)
        model = _fake_model(cfg, aparams, mesh, device, requires_grad=True)
        opt = AdamWState(
            step=_fake(astate.step, mesh, device),
            mu={k: _fake(a, mesh, device) for k, a in astate.mu.items()},
            nu={k: _fake(a, mesh, device) for k, a in astate.nu.items()})
        named = dict(model.named_parameters())
        ef = init_error_feedback(named) if grad_compression else None

        def train_step(params, opt_state, batch):
            nonlocal ef
            loss, metrics = loss_fn(params, batch, cfg, mesh=mesh,
                                    rules=rules)
            loss.backward()
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p)).redistribute(
                             mesh, p.placements)
                     for k, p in params.named_parameters()}
            if grad_compression:
                grads, ef = compress_decompress(grads, ef)
            _, new_state, om = adamw_update(dict(params.named_parameters()),
                                            grads, opt_state, adamw)
            params.zero_grad(set_to_none=True)
            return params, new_state, {"loss": loss, **metrics, **om}

        return train_step, (model, opt, batch)

    aparams, _ = abstract_params(cfg, rules, mesh)
    model = _fake_model(cfg, aparams, mesh, device,
                        dtype=torch_dtype(cfg.compute_dtype),
                        requires_grad=False)
    acaches, _ = abstract_caches(cfg, shape.global_batch, shape.seq_len,
                                 rules, mesh)
    if shape.kind == "prefill":
        caches = _fake_tree(acaches, mesh, device, 0)

        @torch.no_grad()
        def prefill_step(params, batch, caches):
            return prefill(params, batch, caches, cfg, mesh=mesh,
                           rules=rules)

        return prefill_step, (model, batch, caches)

    # decode: one token against a seq_len cache (seq_len - 1 held)
    caches = _fake_tree(acaches, mesh, device, shape.seq_len - 1)

    @torch.no_grad()
    def serve_step(params, batch, caches):
        return decode_step(params, batch["tokens"], caches, cfg, mesh=mesh,
                           rules=rules, enc_out=batch.get("enc_out"))

    return serve_step, (model, batch, caches)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             *, rules_override=None, tag: str = "",
             cfg_override: dict | None = None, device: str = "cuda",
             grad_compression: bool = False,
             seq_len: int | None = None) -> dict:
    """Trace and count one cell; the record is written to
    ``out_dir/<arch>_<shape>_<mesh>[_<tag>].json`` and returned, with
    ``coll_events`` (each collective as it ran; not written) beside it.  ``seq_len`` cuts the shape's sequence (the CPU tests'
    sweep); ``grad_compression`` adds the int8 round trip to a train
    step.  The count is of the whole step with every loop trip run, so
    no loop correction applies: ``flops_per_device_raw`` equals
    ``flops_per_device`` (and the bytes alike), and ``units`` is a
    per-block-kind breakdown, each unit's ``total`` its ``once``.  Raises if this process already has a ``torch.distributed``
    world, or for ``device="cuda"`` on a host without a card."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import rules_for
    from repro_torch.models.transformer import resolve_device
    from repro_torch.roofline.analysis import model_flops, roofline
    from repro_torch.roofline.costing import cell_units, unit_costs
    from repro_torch.roofline.counting import count_step

    device = resolve_device(device)
    cfg = get_config(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = SHAPES[shape_name]
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    ok, reason = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device=device.type)
        rules = rules_for(mesh, shape.kind, cfg)
        if rules_override:
            rules = rules.replace(**rules_override)
        t0 = time.perf_counter()
        with fake_mode():
            fn, args = build_step(cfg, shape, mesh, rules, device=device,
                                  grad_compression=grad_compression)
            got = count_step(fn, *args)
            trace_s = time.perf_counter() - t0
            caches = args[2] if shape.kind != "train" else None
            unit_records = [
                {"unit": unit, **unit_costs(cfg, unit, shape, mesh, rules,
                                            args[0], caches, device=device)}
                for unit in cell_units(cfg, shape)]
        chips = mesh.size()
    coll = got["coll"]
    flops, byts = float(got["flops"]), float(got["bytes"])
    mf = model_flops(cfg, shape, _active_params(cfg))
    rep = roofline(arch=arch, shape=shape_name, mesh=mesh_kind, chips=chips,
                   hlo_flops=flops, hlo_bytes=byts,
                   collective_bytes=float(coll["total_operand_bytes"]),
                   model_flops_=mf)
    rec.update(
        status="ok",
        chips=chips,
        trace_s=round(trace_s, 1),
        memory={"argument_bytes": got["argument_bytes"],
                "output_bytes": got["output_bytes"],
                "temp_bytes": got["temp_bytes"],
                "peak_bytes": got["peak_bytes"]},
        # the eager count is complete (no loop counted once), so the raw
        # and the per-device numbers are one
        cost={"flops_per_device_raw": flops, "bytes_per_device_raw": byts,
              "flops_per_device": flops, "bytes_per_device": byts,
              "collective_bytes": float(coll["total_operand_bytes"])},
        units=[{"kind": u["unit"].kind, "count": u["unit"].count,
                "trips": u["unit"].trips,
                "total_flops": u["total"]["flops"],
                "once_flops": u["once"]["flops"]} for u in unit_records],
        collectives={k: v for k, v in coll.items()
                     if not isinstance(v, dict) or v["count"]},
        roofline=rep.as_dict(),
    )
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{ALIASES.get(arch, arch).replace('-', '_')}_{shape_name}_{mesh_kind}"
    if tag:
        name += f"_{tag}"
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
    rec["coll_events"] = got["coll_events"]
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="")
    p.add_argument("--shape", default="")
    p.add_argument("--mesh", default="single", choices=["single", "multi",
                                                        "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="runs/dryrun")
    p.add_argument("--tag", default="")
    p.add_argument("--rules", default="",
                   help="logical=axis1+axis2,... rule overrides")
    p.add_argument("--cfg", default="",
                   help="field=value,... ModelConfig overrides (int/bool)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the mesh's device type (cpu: the CPU tests' "
                        "collectives)")
    args = p.parse_args(argv)
    from repro_torch.models.transformer import resolve_device
    resolve_device(args.device)         # no card for cuda: raise here

    overrides = None
    if args.rules:
        overrides = {}
        for kv in args.rules.split(","):
            k, v = kv.split("=")
            overrides[k] = tuple(a for a in v.split("+") if a)

    out = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list(ARCHITECTURES) if args.all or not args.arch \
        else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                label = f"{arch} × {shape} × {mk}"
                cfg_over = None
                if args.cfg:
                    cfg_over = {}
                    for kv in args.cfg.split(","):
                        k, v = kv.split("=")
                        cfg_over[k] = (v == "true" if v in ("true", "false")
                                       else int(v) if v.isdigit() else v)
                try:
                    rec = run_cell(arch, shape, mk, out,
                                   rules_override=overrides, tag=args.tag,
                                   cfg_override=cfg_over, device=args.device)
                    if rec["status"] == "ok":
                        r = rec["roofline"]
                        print(f"[dryrun] OK  {label}: trace={rec['trace_s']}s "
                              f"peak={rec['memory']['peak_bytes']/1e9:.2f}GB/dev "
                              f"bottleneck={r['bottleneck']}", flush=True)
                    else:
                        print(f"[dryrun] SKIP {label}: {rec['reason']}",
                              flush=True)
                except Exception as e:   # noqa: BLE001
                    failures += 1
                    print(f"[dryrun] FAIL {label}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
