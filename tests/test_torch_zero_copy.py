"""The port's zero-copy and packed-grid introspection on the CPU: the
thread-safe launch recorder, the copy counter on ``run_op``'s dispatch path,
the Hopper grid formulas, and ``padded_run`` against the reference
package's ``padded_run`` (interpret mode) on the same seeded inputs, within
5e-4 relative to the largest output (the reference conformance harness's
float32 limit).  On the card, ``chip_smoke.py`` and ``test_torch_gpu.py``
hold the recorded grids to these formulas and the masked kernels to the
padded ones bit for bit."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.padded_ref import padded_run as ref_padded_run
from repro_torch.kernels import introspect as I
from repro_torch.kernels import ops
from repro_torch.kernels.padded_ref import block_knob, padded_run

TOL = 5e-4

#: the ragged and one-row dims of the reference's zero-copy tests
RAGGED = {"gemm": (129, 65, 257), "symm": (129, 257), "syrk": (129, 65),
          "syr2k": (129, 65), "trmm": (129, 257), "trsm": (129, 257)}
ONE_ROW = {"gemm": (1, 300, 384), "symm": (1, 384), "syrk": (1, 384),
           "syr2k": (1, 384), "trmm": (1, 384), "trsm": (1, 384)}
VARIANTS = {"syrk": ("full", "tri", "tri_packed"),
            "syr2k": ("full", "tri", "tri_packed"),
            "trmm": ("full", "tri", "tri_packed")}


def _operands(op, dims, seed=5):
    rng = np.random.default_rng(seed)
    if op == "gemm":
        m, k, n = dims
        shapes = ((m, k), (k, n))
    elif op in ("symm", "trmm", "trsm"):
        m, n = dims
        shapes = ((m, m), (m, n))
    else:
        shapes = (dims,) * (1 if op == "syrk" else 2)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if op == "trsm":
        xs[0] += dims[0] * np.eye(dims[0], dtype=np.float32)
    return xs


# ---------------------------------------------------------------------------
# the launch recorder
# ---------------------------------------------------------------------------

def test_recorder_counts_concurrent_launches_exactly():
    I.reset_launches()
    per_thread, threads = 2000, 8
    barrier = threading.Barrier(threads)

    def hammer(t):
        barrier.wait()
        kernel = I.KERNELS[t % len(I.KERNELS)]
        for _ in range(per_thread):
            I.record_launch(kernel, (1, 2, 3))

    pool = [threading.Thread(target=hammer, args=(t,))
            for t in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)       # switch threads as often as it can
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    counts = I.launch_counts()
    assert sum(counts.values()) == per_thread * threads
    for t in range(threads):
        kernel = I.KERNELS[t % len(I.KERNELS)]
        share = sum(1 for u in range(threads)
                    if I.KERNELS[u % len(I.KERNELS)] == kernel)
        assert counts[kernel] == share * per_thread
    I.reset_launches()
    assert set(I.launch_counts().values()) == {0}


def test_capture_sees_only_the_calling_threads_launches():
    I.reset_launches()
    started, release = threading.Event(), threading.Event()

    def other():
        started.set()
        release.wait(timeout=30)
        for _ in range(50):
            I.record_launch("gemm", (9, 9, 9))

    t = threading.Thread(target=other)
    t.start()
    started.wait(timeout=30)
    with I.capture_launches() as mine:
        release.set()
        for i in range(3):
            I.record_launch("trmm", (i, 1, 1))
        t.join(timeout=30)
    assert mine == [("trmm", (i, 1, 1)) for i in range(3)]
    assert I.launch_counts()["gemm"] == 50
    with I.capture_launches() as outer:
        with I.capture_launches() as inner:
            I.record_launch("symm", (1, 1, 1))
        I.record_launch("rank_k", (2, 2, 1))
    assert inner == [("symm", (1, 1, 1))]
    assert outer == [("symm", (1, 1, 1)), ("rank_k", (2, 2, 1))]


def test_recorder_refuses_unknown_kernels():
    with pytest.raises(ValueError):
        I.record_launch("herk", (1, 1, 1))


# ---------------------------------------------------------------------------
# the copy counter
# ---------------------------------------------------------------------------

def test_copy_counter_catches_a_pad_and_a_clone():
    x = torch.randn(4, 5)
    counts = I.copy_op_counts(
        lambda: (torch.nn.functional.pad(x, (0, 3, 0, 1)), x.clone()))
    assert counts == {"constant_pad_nd": 1, "clone": 1}
    counts = I.copy_op_counts(
        lambda: (torch.cat([x, x]), torch.stack([x, x]), x.contiguous(),
                 x.t().contiguous(), x[torch.tensor([0, 2])]))
    assert counts["cat"] == 1 and counts["stack"] == 1
    assert counts["clone"] == 1 and counts["index"] == 1


def test_copy_counter_ignores_views_and_empty():
    x = torch.randn(4, 5)
    counts = I.copy_op_counts(lambda: (x[1:3], x.t(), x.view(5, 4),
                                       x.unsqueeze(0), x[..., :2],
                                       torch.empty(3, 3)))
    assert counts == {}


@pytest.mark.parametrize("op", ("gemm", "symm", "syrk", "syr2k", "trmm"))
@pytest.mark.parametrize("dims_key", ("ragged", "one-row"))
def test_no_copy_in_dispatch_on_cpu(op, dims_key):
    dims = RAGGED[op] if dims_key == "ragged" else ONE_ROW[op]
    xs = tuple(map(torch.from_numpy, _operands(op, dims)))
    for variant in VARIANTS.get(op, ("full",)):
        counts = I.copy_op_counts(ops.run_op, op, xs, device="cpu",
                                  knob=block_knob(op, 128, variant))
        assert counts == {}, (op, variant, counts)


def test_trsm_dispatch_has_no_pad():
    xs = tuple(map(torch.from_numpy, _operands("trsm", RAGGED["trsm"])))
    counts = I.copy_op_counts(ops.run_op, "trsm", xs, device="cpu",
                              knob=block_knob("trsm", 128))
    assert "constant_pad_nd" not in counts


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,bm,bn,full,packed", [
    ((129, 257), 64, 128, (3, 3, 1), (3, 2, 1)),
    ((4096, 14336), 128, 128, (112, 32, 1), (112, 16, 1)),
    ((512, 512), 128, 128, (4, 4, 1), (4, 2, 1)),
    ((1, 384), 64, 64, (6, 1, 1), (6, 1, 1)),
])
def test_trmm_grids(dims, bm, bn, full, packed):
    assert I.full_grid_for("trmm", dims, bm, bn) == full
    assert I.packed_grid_for("trmm", dims, bm, bn) == packed
    assert I.packed_slot_ratio("trmm", dims, bm, bn) == \
        I.grid_slots(full) / I.grid_slots(packed)


def test_rank_k_grids_and_slot_ratio():
    assert I.full_grid_for("syrk", (129, 65), 64, 16, batch=3) == (3, 3, 3)
    assert I.packed_grid_for("syr2k", (129, 65), 64, 16, batch=3) == \
        (6, 1, 3)
    # nb^2 tiles against nb (nb + 1) / 2: 2 nb / (nb + 1)
    assert I.packed_slot_ratio("syrk", (4096, 14336), 128) == \
        pytest.approx(2 * 32 / 33)
    assert I.full_grid_for("gemm", (129, 65, 257), 64, 128) == (3, 3, 1)
    assert I.full_grid_for("symm", (129, 257), 64, 128, batch=8) == \
        (3, 3, 8)
    for op in ("symm", "gemm", "trsm"):
        with pytest.raises(ValueError):
            I.packed_grid_for(op, RAGGED[op], 64, 64)


@pytest.mark.parametrize("op", ("syrk", "syr2k", "trmm"))
def test_packed_launches_fewer_blocks_than_tri(op):
    for dims in ((129, 257), (300, 300), (4096, 14336)):
        for bm in (64, 128):
            assert I.grid_slots(I.packed_grid_for(op, dims, bm, 64)) < \
                I.grid_slots(I.full_grid_for(op, dims, bm, 64))


# ---------------------------------------------------------------------------
# padded_run against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ("gemm", "symm", "syrk", "syr2k", "trmm",
                                "trsm"))
def test_padded_run_matches_reference_padded_run(op):
    xs = _operands(op, RAGGED[op])
    variants = VARIANTS.get(op, ("full",))
    for variant in variants:
        got = padded_run(op, tuple(map(torch.from_numpy, xs)),
                         variant=variant)
        want = np.asarray(ref_padded_run(op, tuple(map(jnp.asarray, xs)),
                                         variant=variant, interpret=True),
                          np.float64)
        assert tuple(got.shape) == want.shape
        err = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
        assert err < TOL, (op, variant, err)
        masked = ops.run_op(op, tuple(map(torch.from_numpy, xs)),
                            knob=block_knob(op, 128, variant), device="cpu")
        assert torch.allclose(masked, got, rtol=1e-5, atol=1e-4)


def test_block_knob_is_in_the_knob_space():
    for op in ("gemm", "symm", "syrk", "syr2k", "trmm", "trsm"):
        for variant in VARIANTS.get(op, ("full",)):
            assert block_knob(op, 128, variant) in \
                ops.knob_space_for(op).candidates
