"""The port's dry run (``launch/dryrun.py``) on a fake world, the sharded
path it found broken and its repair, and the ``cpu_blocked`` backend.

- ``python -m repro_torch.launch.dryrun`` (its ``main``) on the CPU
  exits 0 and writes the reference's record keys, ``trace_s`` in place
  of ``lower_s`` and ``compile_s``; ``--device cuda`` without a card
  raises; a cell refuses to start inside a live world and leaves none up.
- Byte counts: a ``decode_32k`` step of starcoder2-15b (kv 4 on a
  16-way model axis) at (16, 16) keeps its seq-sharded KV cache sharded
  (no layer gathers it; the shards' softmax pieces are combined by two
  small all-reduces), and an int8-compressed ``train_4k`` step still
  reduces its gradients in float32, as the reference's does.  Both cut
  to 2 layers (the counts are per layer); the decode keeps its 32k
  cache, the train step is cut to 256 positions.
- The repair, in real ``gloo`` worlds of 4 ranks on (1, 4) and (2, 2):
  configs whose heads and kv heads do not divide the model axis (6 heads,
  2 kv heads, head dim 16 on model = 4, under the production rules that
  partition such attention by batch), an expert-parallel MoE and a
  slot-parallel one (6 experts on model = 4): the sharded loss within
  1e-5 of the unsharded one and each gradient within 1e-4 of its max,
  and the same against the reference's ``jax.value_and_grad(loss_fn)``
  on the same weights (carried across with ``to_reference``, in the test
  process only), which GSPMD shards at these head and expert counts
  without changing the maths.
- ``cpu_blocked``: bit-equal to the reference's ``run_blocked`` for the
  six ops x their variants x float32 and float64, its knob spaces equal to
  the reference backend's, the conformance harness at float32 and
  float64, and a tiny ``calibrate --backend cpu_blocked --precisions
  s,d`` install that loads and answers ``select``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import _spawn

SRC = Path(__file__).resolve().parents[1] / "src"

#: the keys of the reference's record, but for its lower_s and compile_s
RECORD_KEYS = {"arch", "shape", "mesh", "tag", "status", "chips", "trace_s",
               "memory", "cost", "units", "collectives", "roofline"}


# ---------------------------------------------------------------------------
# the CLI and the world it starts
# ---------------------------------------------------------------------------

def test_main_writes_the_reference_record_keys(tmp_path):
    from repro_torch.launch import dryrun
    rc = dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                      "--mesh", "single", "--cfg", "n_layers=2",
                      "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    (path,) = tmp_path.glob("*.json")
    assert path.name == "llama3_8b_decode_32k_single.json"
    rec = json.loads(path.read_text())
    assert set(rec) == RECORD_KEYS
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert set(rec["cost"]) == {"flops_per_device_raw",
                                "bytes_per_device_raw", "flops_per_device",
                                "bytes_per_device", "collective_bytes"}
    # the eager count is complete: no loop correction
    assert rec["cost"]["flops_per_device_raw"] == \
        rec["cost"]["flops_per_device"] > 0
    assert set(rec["roofline"]) >= {"t_compute", "t_memory", "t_collective",
                                    "bottleneck", "useful_ratio"}
    for u in rec["units"]:
        assert u["total_flops"] == u["once_flops"] > 0
    assert rec["memory"]["peak_bytes"] == (rec["memory"]["temp_bytes"]
                                           + rec["memory"]["argument_bytes"])
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_device_without_a_card_raises(tmp_path):
    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                     "--device", "cuda", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("llama3-8b", "decode_32k", "single", tmp_path)


def test_a_cell_refuses_a_live_world(tmp_path):
    from repro_torch.launch import dryrun
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="already has"):
            dryrun.run_cell("llama3-8b", "decode_32k", "single", tmp_path,
                            device="cpu", cfg_override={"n_layers": 2})


def test_real_steps_before_and_after_a_cell_share_no_tensor(tmp_path):
    """A real step before and after a dry cell on the same device give
    the same loss: the cell takes no real tensor from the models' cache
    (RoPE's frequencies) into its fake mode and leaves no fake one in it
    (``dryrun.fake_mode``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params, loss_fn
    cfg = dataclasses.replace(get_smoke_config("llama3_8b"),
                              compute_dtype="float32")
    model = init_params(0, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        before = loss_fn(model, batch, cfg)[0]
        rec = dryrun.run_cell("llama3-8b", "decode_32k", "single", tmp_path,
                              device="cpu", cfg_override={"n_layers": 2})
        after = loss_fn(model, batch, cfg)[0]
    assert rec["status"] == "ok"
    assert torch.equal(before, after)


def test_import_loads_no_jax_repro_or_msgpack_and_no_world():
    code = ("import sys, torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.roofline\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
            "'msgpack') or m.startswith(('jax.', 'repro.', 'msgpack.')))\n"
            "print(bad, dist.is_initialized())\n"
            "sys.exit(1 if bad or dist.is_initialized() else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=SRC.parent,
                          env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# ROADMAP Queue 3's byte counts
# ---------------------------------------------------------------------------

def test_seq_sharded_cache_is_gathered_whole_every_decode_layer(tmp_path):
    """The fault this test is named after, repaired: a decode step over
    starcoder2-15b's seq-sharded KV cache (kv 4 on model = 16, the SP
    fallback) at (16, 16) gathers no cache shard, where it gathered k and
    v whole in every layer (21.47 GB a step a rank at 40 layers).  Each
    layer's collectives on activations (the one-token q, k and v to every
    head, the shards' log-sum-exp combine, the row-parallel reduces) come
    to at most 3 x B_local·H·hd·4 bytes; the combine is two all-reduces a
    layer, the max and the rescaled sums in float32."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import run_cell
    layers = 2
    cfg = get_config("starcoder2-15b")
    shape = SHAPES["decode_32k"]
    rec = run_cell("starcoder2-15b", "decode_32k", "single", tmp_path,
                   cfg_override={"n_layers": layers}, device="cpu")
    b_local = shape.global_batch // 16               # batch over 'data'
    shard = (b_local, shape.seq_len // 16, cfg.kv_heads, cfg.hd())
    events = rec["coll_events"]
    assert not [e for e in events if shard in e.shapes]
    unit = b_local * cfg.n_heads * cfg.hd() * 4
    on_rows = [e for e in events if e.shapes[0][0] == b_local]
    assert all(e.group == 16 for e in on_rows)
    assert sum(e.operand_bytes for e in on_rows) <= 3 * unit * layers
    combine = [e for e in on_rows if e.kind == "all-reduce"
               and e.dtype == torch.float32]
    assert len(combine) == 2 * layers


def test_compressed_gradients_still_reduce_in_float32(tmp_path):
    from repro_torch.launch.dryrun import run_cell
    kw = dict(cfg_override={"n_layers": 2}, device="cpu", seq_len=256)
    plain = run_cell("llama3-8b", "train_4k", "single", tmp_path, **kw)
    packed = run_cell("llama3-8b", "train_4k", "single", tmp_path,
                      grad_compression=True, tag="int8", **kw)

    def reduces(rec):
        return Counter((e.kind, e.dtype, e.shapes, e.operand_bytes)
                       for e in rec["coll_events"]
                       if e.kind in ("reduce-scatter", "all-reduce"))

    # every reduce of the plain step runs as it was: the float32 ones (the
    # gradients of the float32 parameters, the data-parallel reduce) as
    # well as the bf16 ones (sequence-parallel activations); the round
    # trip adds only the float32 reductions of its scales' max |g| across
    # the shards
    extra = reduces(packed) - reduces(plain)
    assert not reduces(plain) - reduces(packed)
    grads = {k: n for k, n in reduces(plain).items()
             if k[1] == torch.float32}
    total = sum(k[3] * n for k, n in grads.items())
    assert total > 0
    assert {k[1] for k in extra} == {torch.float32}
    assert sum(k[3] * n for k, n in extra.items()) < 0.01 * total
    assert not any(e.dtype == torch.int8 for e in packed["coll_events"])


# ---------------------------------------------------------------------------
# the repaired sharded path in real gloo worlds
# ---------------------------------------------------------------------------

B, S = 4, 16


#: the repair's configs: name -> (smoke architecture, fields replaced)
REPAIR = {
    # 6 heads and 2 kv heads of 16 on model = 4: q, k and v views
    "uneven_heads": ("llama3_8b", dict(n_heads=6, kv_heads=2, head_dim=16,
                                       d_model=96)),
    # MLA + MoE, the experts over the model axis (EP)
    "moe_ep": ("deepseek_v2_lite", dict(capacity_factor=8.0)),
    # 6 experts on model = 4: slot-parallel over the capacity dim
    "moe_slots": ("granite_moe_3b", dict(n_experts=6, capacity_factor=8.0)),
}


def _repair_cfgs() -> dict:
    from repro_torch.configs import get_smoke_config
    return {name: dataclasses.replace(get_smoke_config(arch),
                                      compute_dtype="float32", **kw)
            for name, (arch, kw) in REPAIR.items()}


def _batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)),
            "labels": rng.integers(0, cfg.vocab, (B, S))}


def _loss_and_grads(cfg, mesh):
    """The loss and every gradient, whole, of the seed-0 model under the
    production rules (``rules_for`` with the config)."""
    from repro_torch.data import make_global_batch
    from repro_torch.distributed import reshard
    from repro_torch.launch.specs import param_specs, rules_for
    from repro_torch.models import init_params, loss_fn
    model = init_params(0, cfg, device="cpu").requires_grad_(True)
    rules = None
    if mesh is not None:
        rules = rules_for(mesh, "train", cfg)
        specs = param_specs(cfg, model, rules, mesh)
        reshard(model, mesh, lambda name, _: specs[name])
    batch = make_global_batch(_batch(cfg), mesh,
                              None if mesh is None else ("data",),
                              device="cpu")
    loss, _ = loss_fn(model, batch, cfg, mesh=mesh, rules=rules)
    loss.backward()
    grads = {}
    for k, p in model.named_parameters():
        g = p.grad
        if mesh is not None:
            g = g.redistribute(p.device_mesh, p.placements).full_tensor()
        grads[k] = g
    if mesh is not None:
        loss = loss.full_tensor()
    return float(loss.detach()), grads


def _repair_rank(rank, world):
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(*shape)
        for name, cfg in _repair_cfgs().items():
            out[shape, name] = _loss_and_grads(cfg, mesh)
    return out


@pytest.fixture(scope="module")
def repaired(tmp_path_factory):
    return _spawn(_repair_rank, 4, tmp_path_factory.mktemp("repair"))


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("name", ["uneven_heads", "moe_ep", "moe_slots"])
def test_repaired_sharded_loss_and_gradients_match_unsharded(
        name, mesh, repaired):
    loss, grads = repaired[mesh, name]
    want_loss, want = _loss_and_grads(_repair_cfgs()[name], None)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert grads.keys() == want.keys()
    for k, w in want.items():
        assert (grads[k] - w).abs().max() <= 1e-4 * w.abs().max().clamp_min(
            1e-30), k


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("name", ["uneven_heads", "moe_ep", "moe_slots"])
def test_repaired_sharded_loss_and_gradients_match_reference(
        name, mesh, repaired):
    """The sharded loss and every gathered gradient against the
    reference's ``value_and_grad`` of its ``loss_fn`` on the same weights
    (``to_reference``) and batch: GSPMD shards these heads and experts
    without changing the maths, so a fault the sharded and the unsharded
    port share shows here."""
    from test_torch_distributed import (assert_grads_match_reference,
                                        reference_loss_and_grads,
                                        reference_of)
    loss, grads = repaired[mesh, name]
    arch, kw = REPAIR[name]
    cfg, rcfg, params = reference_of(arch, **kw)
    assert cfg == _repair_cfgs()[name]
    want_loss, _, want = reference_loss_and_grads(rcfg, params, _batch(cfg))
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert_grads_match_reference(cfg, grads, want, 1e-4)


# ---------------------------------------------------------------------------
# cpu_blocked
# ---------------------------------------------------------------------------

OPS_VARIANTS = {"gemm": ("full",), "symm": ("full",),
                "syrk": ("full", "tri", "tri_packed"),
                "syr2k": ("full", "tri", "tri_packed"),
                "trmm": ("full", "tri", "tri_packed"), "trsm": ("full",)}
BLOCK_DIMS = {"gemm": (70, 50, 90), "symm": (70, 90), "syrk": (70, 50),
              "syr2k": (70, 50), "trmm": (70, 90), "trsm": (70, 90)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("op", list(OPS_VARIANTS))
def test_cpu_blocked_is_bit_equal_to_the_reference(op, dtype):
    import repro.kernels.cpu_blocked as ref
    from repro_torch.kernels import cpu_blocked as port
    from repro_torch.backends import get_backend
    be = get_backend("cpu_blocked")
    for seed, variant in enumerate(OPS_VARIANTS[op]):
        operands = port.make_operands(op, BLOCK_DIMS[op], dtype, seed=seed)
        for a, b in zip(operands, ref.make_operands(op, BLOCK_DIMS[op],
                                                    dtype, seed=seed)):
            assert a.tobytes() == b.tobytes()
        knob = {"bm": 32, "bk": 16, "bn": 64, "variant": variant}
        want = ref.run_blocked(op, operands, knob, alpha=0.5)
        got = port.run_blocked(op, operands, knob, alpha=0.5)
        assert got.dtype == want.dtype == dtype
        assert got.tobytes() == want.tobytes()
        # through the backend: torch CPU tensors in and out, no copy made
        tensors = tuple(torch.from_numpy(x) for x in operands)
        from repro_torch.core.knobs import Knob
        out = be.execute(op, tensors, Knob(knob), alpha=0.5)
        assert out.numpy().tobytes() == want.tobytes()


def test_cpu_blocked_knob_spaces_match_the_reference_backend():
    from repro.backends import get_backend as ref_backend
    from repro_torch.backends import CpuBlockedBackend, get_backend
    port, ref = get_backend("cpu_blocked"), ref_backend("cpu_blocked")
    assert isinstance(port, CpuBlockedBackend)
    for op in OPS_VARIANTS:
        for sizes in (None, (64,), (64, 128, 256, 512)):
            got, want = port.knob_space(op, sizes=sizes), \
                ref.knob_space(op, sizes=sizes)
            assert [k.dict for k in got.candidates] == \
                [k.dict for k in want.candidates], (op, sizes)
        assert port.default_knob(op).dict == ref.default_knob(op).dict
    assert port.supports_dtype(torch.float64)
    assert not port.supports_dtype(torch.float16)
    with pytest.raises(ValueError, match="runs on the CPU"):
        port.on("cuda")


def test_cpu_blocked_passes_the_conformance_harness():
    from repro_torch.backends.conformance import run_conformance
    results = run_conformance(["cpu_blocked"],
                              dtypes=(torch.float32, torch.float64),
                              stacked_width=2)
    assert len(results) == 6 * 2 * 2
    bad = [r for r in results if not r.ok]
    assert not bad, bad


def test_cpu_blocked_install_at_s_and_d_loads_and_selects(tmp_path):
    from repro_torch.backends import get_backend
    from repro_torch.core import AdsalaRuntime, ModelRegistry
    from repro_torch.launch import calibrate
    calibrate.main(["--backend", "cpu_blocked", "--out", str(tmp_path),
                    "--ops", "gemm", "--precisions", "s,d", "--samples",
                    "10", "--dim-lo", "8", "--dim-hi", "96",
                    "--footprint-mb", "1", "--sizes", "32,64",
                    "--tune-trials", "1",
                    "--candidates", "LinearRegression,DecisionTree"])
    models = tmp_path / "models"
    for b in (4, 8):
        assert (models / f"cpu_blocked__gemm_b{b}.adsala").exists()
    rt = AdsalaRuntime()
    assert ModelRegistry(models).load_into(rt) == 2
    space = get_backend("cpu_blocked").knob_space("gemm", sizes=(32, 64))
    for b in (4, 8):
        assert rt.has("gemm", b, "cpu_blocked")
        knob = rt.select("gemm", (40, 24, 56), b, backend="cpu_blocked")
        assert knob in space.candidates
