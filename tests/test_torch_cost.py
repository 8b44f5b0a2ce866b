"""Cost accounting: the kernels' cost formulas, the step counter and the
roofline analysis (``repro_torch.kernels.cost``, ``repro_torch.roofline``).

* Each kernel's formula at the shapes of ``PERF.md``'s table of kernels,
  to the digits the table prints (one yardstick with ``chip_smoke.py``).
* A kernel's count, and a reduced model's loss-and-grad count, equal on
  the CPU route (the plain versions, whose own ops are not counted) and
  on ``meta`` (empty outputs of the kernel's shapes).
* The counter on hand-computable cases, on a fake world of 4 ranks in a
  subprocess (no fake default group reaches the pytest worker): a sharded
  matmul counts 1/4 of the unsharded one, a replicated op counts in full,
  a contraction over a split dim counts 1/4 and leaves a partial sum, an
  all-gather that DTensor issues inside an op is in the census, and the
  same step counted three times, its sharding caches cold the first time,
  counts the same.
* The ring costs against the reference's ``collective_census`` on an HLO
  text with the same ops, bytes and groups, and ``roofline_terms``
  against the reference's on the same artifact, rescaled from its TPU
  model to the H100 model.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.roofline import analysis as RA
from repro_torch import configs as TC
from repro_torch.kernels import cost as K
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.roofline import analysis as A
from repro_torch.roofline.counter import StepCounter, count

REPO = Path(__file__).resolve().parents[1]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# ----------------------- one yardstick: PERF.md ------------------------ #

# (kernel, shapes, GFLOP, MB) as PERF.md's table prints them: K1 and K1b
# at smollm-360m's attention (B=8 S=1024 Hq=15 Hkv=5 D=64), K2 and K2b at
# mamba2-1.3b's (B=8 S=1024 H=64 P=64 N=128 chunk 256), K1 at gemma2-9b's
# global layers (B=1 S=8192 Hq=16 Hkv=8 D=256), K3 and K3b at mamba2's
# train workflow (B=4 S=4096, no h0, no dhT)
PERF_TABLE = [
    ("K1", (8, 1024, 15, 5, 64), 16.122, 41.94),
    ("K1b", (8, 1024, 15, 5, 64), 40.305, 84.38),
    ("K2", (8, 1024, 64, 64, 128, 256), 17.483, 276.83),
    ("K2b", (8, 1024, 64, 64, 128, 256), 35.235, 354.43),
    ("K1", (1, 8192, 16, 8, 256), 549.823, 201.33),
    ("K3", (4, 4096, 64, 64, 128, 256), 17.180, 687.88),
    ("K3b", (4, 4096, 64, 64, 128, 256), 51.540, 692.09),
]


@pytest.mark.parametrize("kernel,shape,gflop,mb", PERF_TABLE)
def test_kernel_cost_matches_perf_table(kernel, shape, gflop, mb):
    if kernel in ("K1", "K1b"):
        B, S, Hq, Hkv, D = shape
        q, k = _meta(B, S, Hq, D), _meta(B, S, Hkv, D)
        c = (K.flash_fwd_cost(q, k, causal=True) if kernel == "K1"
             else K.flash_bwd_cost(q, k, causal=True))
    elif kernel in ("K2", "K2b"):
        B, S, H, P, N, Q = shape
        x, Bm = _meta(B, S, H, P), _meta(B, S, N)
        c = (K.ssd_chunk_cost(x, Bm, chunk=Q) if kernel == "K2"
             else K.ssd_chunk_bwd_cost(x, Bm, chunk=Q))
    else:
        B, S, H, P, N, Q = shape
        f32 = torch.float32
        y, st, Cm = (_meta(B, S, H, P, dtype=f32),
                     _meta(B, H, S // Q, P, N, dtype=f32), _meta(B, S, N))
        c = (K.ssd_pass_cost(y, st, Cm, with_h0=False) if kernel == "K3"
             else K.ssd_pass_bwd_cost(_meta(B, S, H, P), st, Cm,
                                      with_dhT=False, with_dh0=False))
    assert round(c.flops / 1e9, 3) == gflop
    assert round(c.bytes / 1e6, 2) == mb


@pytest.mark.parametrize("Sq,Skv,window,q_offset", [
    (64, 64, 0, 0), (64, 64, 13, 0), (16, 64, 0, 48), (16, 64, 5, 32),
    (20, 64, 0, 0), (64, 64, 100, 0)])
def test_attention_pairs_count_the_mask(Sq, Skv, window, q_offset):
    """The pairs the formula counts are the pairs the plain version's
    mask keeps; the causal and windowed closed forms of ``PERF.md``."""
    from repro_torch.kernels.ref import _masked_scores
    q, k = torch.zeros(1, Sq, 1, 4), torch.zeros(1, Skv, 1, 4)
    _, mask = _masked_scores(q, k, causal=True, window=window,
                             attn_softcap=0.0, q_offset=q_offset)
    assert K.attention_pairs(Sq, Skv, window=window,
                             q_offset=q_offset) == int(mask.sum())
    S, W = 8192, 4096
    assert K.attention_pairs(S, S) == S * (S + 1) // 2
    assert K.attention_pairs(S, S, window=W) == W * (W + 1) // 2 + (S - W) * W


# ------------------ a kernel's count: CPU route = meta ------------------ #

def _flash_args(device, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, S, Hq, Hkv, D = 1, 32, 4, 2, 16
    mk = lambda *s: torch.randn(s, generator=g).to(device)
    return mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)


def _ssd_args(device, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, S, H, P, N = 1, 32, 2, 4, 8
    mk = lambda *s: torch.randn(s, generator=g)
    args = (mk(B, S, H, P), mk(B, S, H).abs() * 0.1, -mk(H).abs(),
            mk(B, S, N), mk(B, S, N))
    return tuple(a.to(device) for a in args)


def _kernel_call(name, device):
    q, k, v = _flash_args(device)
    if name == "flash_attention":
        return lambda: ops.flash_attention(q, k, v, window=5,
                                           attn_softcap=30.0)
    if name == "flash_attention_lse":
        return lambda: ops.flash_attention_lse(q, k, v, causal=True,
                                               window=0, attn_softcap=0.0,
                                               q_offset=8)
    if name == "flash_attention_grads":
        o, lse = (t.to(device) for t in ops.flash_attention_lse(
            *_flash_args("cpu"), causal=True, window=0, attn_softcap=0.0))
        return lambda: ops.flash_attention_grads(q, k, v, o, lse, q,
                                                 causal=True, window=0,
                                                 attn_softcap=0.0)
    x, dt, A_, B_, C_ = _ssd_args(device)
    if name == "ssd_chunk":
        return lambda: ops.ssd_chunk(x, dt, A_, B_, C_, chunk=8)
    if name in ("ssd_pass", "ssd_pass_grads"):
        terms = [t.to(device).contiguous() for t in ops.ssd_chunk(
            *_ssd_args("cpu"), chunk=8)]
        h0 = torch.ones((1, 2, 4, 8)).to(device)
        if name == "ssd_pass":
            return lambda: ops.ssd_pass(*terms, C_, h0, dtype=C_.dtype)
        return lambda: ops.ssd_pass_grads(x, h0, terms[1], terms[2],
                                          terms[3], C_, with_dh0=True)
    cot = [t.to(device).contiguous() for t in ops.ssd_chunk(
        *_ssd_args("cpu"), chunk=8)]
    return lambda: ops.ssd_chunk_grads(x, dt, A_, B_, C_, *cot, chunk=8)


KERNEL_CALLS = {"flash_attention": "flash_attention_fwd",
                "flash_attention_lse": "flash_attention_fwd",
                "flash_attention_grads": "flash_attention_bwd",
                "ssd_chunk": "ssd_chunk_kernel",
                "ssd_chunk_grads": "ssd_chunk_bwd_kernel",
                "ssd_pass": "ssd_pass_kernel",
                "ssd_pass_grads": "ssd_pass_bwd_kernel"}


@pytest.mark.parametrize("wrapper", sorted(KERNEL_CALLS))
def test_kernel_count_equal_on_cpu_and_meta(wrapper):
    """The wrapper's count on the CPU route equals its count on meta, and
    both are the kernel's formula alone: the plain version's own ops
    (score-sized products) are not counted.  The outputs agree in shape
    and dtype, and count once in the peak."""
    got = {}
    for device in ("cpu", "meta"):
        fn = _kernel_call(wrapper, device)
        out, tot = count(fn, counter_args=(), device=device)
        got[device] = (tot, [(tuple(t.shape), t.dtype)
                             for t in (out if isinstance(out, tuple)
                                       else (out,))])
    (cpu, cpu_out), (meta, meta_out) = got["cpu"], got["meta"]
    assert cpu_out == meta_out
    name = KERNEL_CALLS[wrapper]
    assert list(cpu["kernels"]) == [name] and cpu["kernels"][name]["calls"] == 1
    for key in ("flops", "bytes", "kernels", "by_name", "peak_bytes"):
        assert cpu[key] == meta[key], key
    k = cpu["kernels"][name]
    assert (cpu["flops"], cpu["bytes"]) == (k["flops"], k["bytes"])
    assert cpu["peak_bytes"] == sum(
        int(np.prod(s)) * torch.empty((), dtype=d).element_size()
        for s, d in cpu_out)


def test_kernel_cost_is_the_formula():
    q, k, v = _flash_args("meta")
    _, tot = count(lambda: ops.flash_attention_lse(
        q, k, v, causal=True, window=5, attn_softcap=0.0, q_offset=16),
        counter_args=())
    c = K.flash_fwd_cost(q, k, window=5, q_offset=16, with_lse=True)
    assert (tot["flops"], tot["bytes"]) == tuple(c)
    assert c.flops == 4 * 16 * K.attention_pairs(32, 32, window=5,
                                                 q_offset=16) * 4


def _reduced(arch, **over):
    cfg = TC.reduce_config(TC.get_config(arch))
    extra = dict(dtype="float32", num_layers=TT.program_period(cfg))
    if cfg.num_experts:
        extra["capacity_factor"] = cfg.num_experts / cfg.num_experts_per_tok
    return dataclasses.replace(cfg, **{**extra, **over})


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-1.3b",
                                  "jamba-1.5-large-398b"])
def test_model_count_equal_on_cpu_and_meta(arch):
    """A reduced model's loss and grads counted on the CPU (the plain
    versions) and on meta (the meta routes): FLOPs, bytes, the kernels'
    costs, bytes by name and the peak all equal, so a count on meta is
    the count of the same step with the kernels, whatever the route."""
    cfg = _reduced(arch)
    tot = {}
    for device in ("cpu", "meta"):
        params = (TT.init_params(cfg, 0, device="cpu") if device == "cpu"
                  else TT.abstract_params(cfg, "float32"))
        g = np.random.default_rng(0)
        toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (2, 33)))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                 "loss_mask": torch.ones(2, 32)}
        batch = {k: v.contiguous().to(device) for k, v in batch.items()}
        _, tot[device] = count(TM.make_loss_and_grad(cfg), params, batch)
    cpu, meta = tot["cpu"], tot["meta"]
    assert cpu["kernels"] and cpu["flops"] > 0
    for key in ("flops", "bytes", "kernels", "by_name", "flops_by_name",
                "peak_bytes", "arg_bytes"):
        assert cpu[key] == meta[key], key


def test_peak_counts_live_storages():
    """Arguments are live from the start; a result counts until freed; a
    view and an in-place op allocate nothing."""
    x = torch.empty(1024, device="meta")

    def step(x):
        y = x * 2.0
        z = (y + 1.0).view(32, 32)
        z.add_(1.0)
        del y
        w = z * 3.0
        return w.sum()
    with StepCounter((x,)) as c:
        step(x)
    assert c.arg_bytes == 4096
    assert c.peak == 3 * 4096 + 4               # x, z, w and the sum
    assert c.bytes == (2 + 2 + 2 + 2 + 1) * 4096 + 4


# ------------------- the counter on a fake world of 4 ------------------- #

_WORLD = r"""
import json, torch
from repro_torch.launch.dryrun import fake_world
from repro_torch.roofline.counter import count
fake_world(4, 3)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
R, S0, S1 = Replicate(), Shard(0), Shard(1)
def dt(t, *pl):
    return DTensor.from_local(t, mesh, [R, *pl], run_check=False)
meta = lambda *s: torch.empty(s, device="meta")
out = {}
_, out["plain_mm"] = count(lambda a, b: a @ b, meta(8, 64), meta(64, 32))
x, w = dt(meta(8, 64), R), dt(meta(64, 8), S1)
_, out["col_mm"] = count(lambda a, b: a @ b, x, w)
a, b = dt(meta(8, 64), R), dt(meta(8, 64), R)
_, out["repl_add"] = count(lambda a, b: a + b, a, b)
_, out["plain_add"] = count(lambda a, b: a + b, meta(8, 64), meta(8, 64))
x, w = dt(meta(8, 16), S1), dt(meta(16, 32), S0)
y, out["contract_mm"] = count(lambda a, b: a @ b, x, w)
out["contract_partial"] = y.placements[1].is_partial()
a, b = dt(meta(8, 16), S0), dt(meta(16, 16), S1)
_, out["implicit"] = count(lambda a, b: a @ b, a, b)
# a reduced model's train step on the mesh, counted three times: the
# first with DTensor's sharding caches cold
import dataclasses
from repro_torch import configs as C
from repro_torch.launch import dryrun as D
rc = C.reduce_config(C.get_config("qwen3-moe-235b-a22b"))
over = {f.name: getattr(rc, f.name) for f in dataclasses.fields(rc) if f.init}
over.update(num_layers=2, vocab_size=256)
cfg, shape, step, args = D.build_cell("qwen3-moe-235b-a22b", "train_4k",
                                      mesh, cfg_overrides=over, mu_override=2)
out["repeats"] = [D.count_cell(step, args)[0] for _ in range(3)]
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def world():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", _WORLD], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.split("RESULT")[1])


def test_sharded_matmul_counts_its_share(world):
    assert world["col_mm"]["flops"] * 4 == world["plain_mm"]["flops"]
    assert world["col_mm"]["collectives"] == []


def test_replicated_op_counts_in_full(world):
    assert world["repl_add"]["bytes"] == world["plain_add"]["bytes"] \
        == 3 * 8 * 64 * 4


def test_partial_contraction_splits(world):
    assert world["contract_mm"]["flops"] * 4 == world["plain_mm"]["flops"]
    assert world["contract_partial"]
    assert world["contract_mm"]["collectives"] == []


def test_implicit_all_gather_is_in_the_census(world):
    coll = world["implicit"]["collectives"]
    assert [(c["op"], c["group_size"], c["intra_node"]) for c in coll] == \
        [("all-gather", 4, True)]
    assert coll[0]["out_bytes"] == 32 * 16 * 4 and coll[0]["count"] == 1
    # the rank's own product: its rows of a against its columns of b
    assert world["implicit"]["flops"] == 2 * 32 * 16 * 16


def test_repeated_counts_agree(world):
    """The step counted three times, DTensor's sharding propagation cold
    the first time: no count takes in its runs at global shapes."""
    first, second, third = world["repeats"]
    assert first["flops"] > 0 and first["collectives"]
    assert first["kernels"]["flash_attention_bwd"]["calls"] > 0
    assert first == second == third


# ------------------------ ring costs, roofline ------------------------- #

_HLO = """
  %ag = bf16[16,1024]{1,0} all-gather(bf16[1,1024]{1,0} %p), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
  %ar = f32[4096]{0} all-reduce(f32[4096]{0} %x), replica_groups=[16,16]<=[256], to_apply=%add
  %ar2 = f32[4096]{0} all-reduce(f32[4096]{0} %x2), replica_groups=[32,8]<=[256], to_apply=%add
  %rs = bf16[64]{0} reduce-scatter(bf16[512]{0} %y), replica_groups=[32,8]<=[256], dimensions={0}
  %a2a = bf16[8,128]{1,0} all-to-all(bf16[8,128]{1,0} %z), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp = f32[256]{0} collective-permute(f32[256]{0} %w), source_target_pairs={{0,1}}
"""
_CENSUS = [
    {"op": "all-gather", "group_size": 16, "intra_node": False, "count": 1,
     "out_bytes": 16 * 1024 * 2},
    {"op": "all-reduce", "group_size": 16, "intra_node": False, "count": 1,
     "out_bytes": 4096 * 4},
    {"op": "all-reduce", "group_size": 8, "intra_node": True, "count": 1,
     "out_bytes": 4096 * 4},
    {"op": "reduce-scatter", "group_size": 8, "intra_node": True, "count": 1,
     "out_bytes": 64 * 2},
    {"op": "all-to-all", "group_size": 4, "intra_node": True, "count": 1,
     "out_bytes": 8 * 128 * 2},
    {"op": "collective-permute", "group_size": 2, "intra_node": True,
     "count": 1, "out_bytes": 256 * 4},
]


def test_ring_costs_match_reference_census():
    want = RA.collective_census(_HLO)
    got = A.collective_census(_CENSUS)
    assert got["ops"] == want["ops"]
    assert got["moved_bytes_per_device"] == want["moved_bytes_per_device"]
    # the links: NVLink where the group lies in a node, InfiniBand else
    seconds = sum(g["moved_bytes"] / (A.NVLINK_BW if g["intra_node"]
                                      else A.IB_BW) for g in got["groups"])
    assert got["seconds"] == pytest.approx(seconds, rel=1e-12)
    assert {g["link"] for g in got["groups"]} == {"nvlink", "infiniband"}


def test_roofline_terms_match_reference_on_the_h100_model():
    coll = A.collective_census(_CENSUS)
    art = {"cost": {"flops_per_device": 3.0e14, "bytes_per_device": 2.0e12},
           "collectives": coll, "n_chips": 256, "model_flops_global": 5e16}
    got = A.roofline_terms(art)
    ref = RA.roofline_terms(art)
    assert set(got) == (set(ref) - {"model_flops_over_hlo_flops"}) | {
        "model_flops_over_counted_flops"}
    assert got["compute_s"] == pytest.approx(
        ref["compute_s"] * RA.PEAK_FLOPS / A.PEAK_FLOPS, rel=1e-12)
    assert got["memory_s"] == pytest.approx(
        ref["memory_s"] * RA.HBM_BW / A.HBM_BW, rel=1e-12)
    assert got["collective_s"] == coll["seconds"]
    assert got["model_flops_over_counted_flops"] == \
        ref["model_flops_over_hlo_flops"]
    bound = max(got["compute_s"], got["memory_s"], got["collective_s"])
    assert got["dominant"] == "memory" and bound == got["memory_s"]
    assert got["roofline_fraction"] == pytest.approx(
        5e16 / 256 / A.PEAK_FLOPS / bound, rel=1e-12)
    assert A.step_share_of_peak(989e12, 1.0) == 1.0
