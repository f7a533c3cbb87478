"""The dry run's sweep on the CPU (``launch/dryrun.py::run_cell``, a fake
world of 256 ranks on a ``cpu`` mesh): every architecture x every shape
``shape_applicable`` admits ends ``ok`` on the single-pod (16, 16) mesh;
``tests/test_torch_dryrun_sweep_multi_*.py`` take the multi-pod
(2, 16, 16) one, split three ways by :func:`multi_part` so that the test
runner spreads them (the third part takes every architecture the first
two do not name, so none falls out of the sweep).

Cut to size: 2 layers (zamba2: one super-block of 6 Mamba2 layers and the
shared block; Whisper: 2 encoder layers too), the production global batch
kept, so that every divisibility is the production one; sequences cut to
256 positions for train and prefill, the decode cache to 1,024 and
long_500k's to 2,048.  A cell's first trace on a mesh pays DTensor's
sharding propagation for every new op shape (most of a multi-pod cell's
5-35 s here).  Each cell's recorded argument bytes equal the ones its
specs give (``argument_bytes``, no world), and its counts are positive.
"""

import pytest

from repro_torch.configs import (ARCHITECTURES, SHAPES, get_config,
                                 shape_applicable)

SEQ = {"train_4k": 256, "prefill_32k": 256, "decode_32k": 1024,
       "long_500k": 2048}


def cells(archs=ARCHITECTURES):
    return [(a, s) for a in archs for s in SHAPES
            if shape_applicable(get_config(a), SHAPES[s])[0]]


#: the multi-pod sweep's first two parts, by trace time; the third is the
#: rest of ``ARCHITECTURES``
MULTI_PARTS = (("zamba2_1p2b", "rwkv6_1p6b", "whisper_medium"),
               ("granite_moe_3b", "deepseek_v2_lite", "internvl2_76b"))


def multi_part(k: int) -> list:
    """The cells of part ``k`` (1 to 3) of the multi-pod sweep."""
    if k <= len(MULTI_PARTS):
        return cells(MULTI_PARTS[k - 1])
    named = {a for part in MULTI_PARTS for a in part}
    return cells(tuple(a for a in ARCHITECTURES if a not in named))


def cut(arch) -> dict:
    cfg = get_config(arch)
    over = {"n_layers": (cfg.shared_attn_every if cfg.family == "hybrid"
                         else 2)}
    if cfg.n_enc_layers:
        over["n_enc_layers"] = 2
    return over


def check_cell(arch, shape, mesh_kind, tmp_path):
    import dataclasses
    from repro_torch.launch.dryrun import argument_bytes, run_cell
    from repro_torch.launch.specs import rules_for
    from repro_torch.models.sharding import AbstractMesh
    rec = run_cell(arch, shape, mesh_kind, tmp_path, cfg_override=cut(arch),
                   device="cpu", seq_len=SEQ[shape])
    assert rec["status"] == "ok"
    assert rec["chips"] == (512 if mesh_kind == "multi" else 256)
    cfg = dataclasses.replace(get_config(arch), **cut(arch))
    sh = dataclasses.replace(SHAPES[shape], seq_len=SEQ[shape])
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model"))
            if mesh_kind == "multi"
            else AbstractMesh((16, 16), ("data", "model")))
    assert rec["memory"]["argument_bytes"] == argument_bytes(
        cfg, sh, mesh, rules_for(mesh, sh.kind, cfg))
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["cost"]["bytes_per_device"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert [u["kind"] for u in rec["units"]]
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


@pytest.mark.parametrize("arch,shape", cells())
def test_single_pod_cell_traces(arch, shape, tmp_path):
    check_cell(arch, shape, "single", tmp_path)
