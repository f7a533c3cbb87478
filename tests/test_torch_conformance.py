"""The port's conformance harness (``repro_torch.backends.conformance``):
its float64 oracle against the reference harness's, and the sweep over the
``hopper`` backend (bound to the CPU, where its kernels compute their plain
versions) and the ``ref`` backend."""

import numpy as np
import pytest
import torch

import repro.backends.conformance as ref_conf
from repro_torch.backends import HopperBackend
from repro_torch.backends import conformance as conf
from repro_torch.kernels import ops


def test_dims_match_the_reference_harness():
    assert conf.DEFAULT_DIMS == ref_conf.DEFAULT_DIMS
    assert conf.RAGGED_DIMS == ref_conf.RAGGED_DIMS
    assert conf.TOLERANCES == ref_conf.TOLERANCES


@pytest.mark.parametrize("op", sorted(conf.DEFAULT_DIMS))
def test_oracle_matches_the_reference_oracle(op):
    be = HopperBackend(device="cpu")
    operands = tuple(x.numpy() for x in be.make_operands(
        op, conf.DEFAULT_DIMS[op], seed=2))
    assert np.allclose(conf.oracle(op, operands),
                       ref_conf.oracle(op, operands), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("op", sorted(conf.DEFAULT_DIMS))
def test_make_operands_shapes(op):
    be = HopperBackend(device="cpu")
    d = conf.DEFAULT_DIMS[op]
    if op == "gemm":
        want = [(d[0], d[1]), (d[1], d[2])]
    elif op in ("syrk", "syr2k"):
        want = [d] * (1 if op == "syrk" else 2)
    else:
        want = [(d[0], d[0]), d]
    got = be.make_operands(op, d, seed=1)
    assert [tuple(x.shape) for x in got] == [tuple(s) for s in want]
    again = be.make_operands(op, d, seed=1)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_run_conformance_over_the_hopper_and_ref_backends_on_cpu():
    results = conf.run_conformance(["hopper", "ref"], dtypes=(torch.float32,),
                                   stacked_width=3, ragged=True,
                                   device="cpu")
    assert len(results) == (6 + 6) * 4 * 2
    bad = [r.line() for r in results if not r.ok]
    assert not bad, bad


@pytest.mark.parametrize("op", ("symm", "syrk", "syr2k", "trmm", "trsm"))
def test_every_knob_with_c_within_the_card_limit_on_cpu(op):
    for knob in ops.knob_space_for(op):
        for stacked in (0, 3):
            res = conf.check_backend_op("hopper", op, dims=(129, 257),
                                        knob=knob, device="cpu",
                                        stacked=stacked, with_c=True,
                                        alpha=0.5, beta=2.0, tol=2e-5)
            assert res.ok, res.line()


def test_float64_is_skipped_not_excused_on_the_hopper_backend():
    res = conf.check_backend_op("hopper", "symm", torch.float64,
                                device="cpu")
    assert res.skipped and not res.ok


def test_oracle_reads_c_per_variant():
    a, c = np.eye(3), np.arange(9.0).reshape(3, 3)
    full = conf.oracle("syrk", (a, c), alpha=1.0, beta=1.0)
    for variant in ("tri", "tri_packed"):
        tri = conf.oracle("syrk", (a, c), alpha=1.0, beta=1.0,
                          variant=variant)
        assert np.array_equal(tri, np.eye(3) + np.tril(c)
                              + np.tril(c, -1).T)
    assert np.array_equal(full, np.eye(3) + c)


@pytest.mark.parametrize("op,dims", [
    ("gemm", (129, 65, 257)), ("gemm", (1, 300, 384)), ("symm", (129, 257)),
    ("symm", (1, 384)), ("syrk", (129, 257)), ("syrk", (1, 384)),
    ("syr2k", (300, 300)), ("trsm", (129, 257))])
def test_error_scale_is_the_largest_output_of_a_full_product(op, dims):
    be = HopperBackend(device="cpu")
    xs = tuple(x.numpy() for x in be.make_operands(op, dims, seed=1))
    want = conf.oracle(op, xs)
    assert conf.error_scale(op, xs, want) == np.max(np.abs(want))


def test_error_scale_floors_a_single_cancelling_dot_product():
    """A 1 x 1 syr2k is one dot product: its value may cancel to near zero,
    and then float32 rounding alone, in any summation order, exceeds 2e-5
    of it (the plain version does on some seeds).  The floor
    ||a|| ||b|| / sqrt(k) holds every seed to the card's limit."""
    be = HopperBackend(device="cpu")
    for seed in range(200):
        a, b = (x.numpy() for x in be.make_operands("syr2k", (1, 384),
                                                     seed=seed))
        want = conf.oracle("syr2k", (a, b))
        got = (2.0 * (torch.from_numpy(a) @ torch.from_numpy(b).mT)).numpy()
        err = np.abs(got.astype(np.float64) - want).max()
        assert err / conf.error_scale("syr2k", (a, b), want) < 2e-5
