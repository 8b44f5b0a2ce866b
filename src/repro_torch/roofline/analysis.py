"""Roofline analysis: the collectives' cost and the three-term model.

The collective census comes from :class:`repro_torch.roofline.counter.
StepCounter`: each entry an op, its output bytes B, its group of g ranks
and whether the group lies in one node.  Each op moves, per rank, the
reference's ring-algorithm bytes (``repro.roofline.analysis``):

  all-gather(out B, groups of g):      B*(g-1)/g
  reduce-scatter(out B, groups of g):  B*(g-1)     (operand = B*g)
  all-reduce(B, groups of g):          2*B*(g-1)/g (RS + AG)
  all-to-all(B, groups of g):          B*(g-1)/g
  collective-permute / broadcast(B):   B

Hardware model, NVIDIA H100 SXM data sheet (no number of a TPU): 989e12
FLOP/s bf16 dense on the tensor cores, 3.35e12 B/s HBM3; NVLink 4 at 450
GB/s a direction between the 8 GPUs of a node; 400 Gb/s InfiniBand, 50
GB/s a GPU, between nodes.  A group moves at NVLink's rate only when all
its ranks share a node.
"""
from __future__ import annotations

from typing import Dict, Iterable

HARDWARE = "NVIDIA H100 SXM data sheet"
PEAK_FLOPS = 989e12          # bf16 dense, per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
NVLINK_BW = 450e9            # bytes/s a direction, within a node of 8
IB_BW = 50e9                 # bytes/s per GPU between nodes (400 Gb/s)
NODE_SIZE = 8


def hardware_model() -> Dict:
    return {"name": HARDWARE, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
            "nvlink_bw": NVLINK_BW, "ib_bw": IB_BW, "node_size": NODE_SIZE}


def moved_bytes(op: str, out_bytes: float, g: int) -> float:
    """Bytes one rank moves for ``op`` with output ``out_bytes`` over a
    group of ``g`` ranks (ring algorithms)."""
    if op == "all-gather":
        return out_bytes * (g - 1) / max(g, 1)
    if op == "reduce-scatter":
        return out_bytes * (g - 1)
    if op == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / max(g, 1)
    if op == "all-to-all":
        return out_bytes * (g - 1) / max(g, 1)
    return float(out_bytes)          # collective-permute, broadcast


def collective_census(entries: Iterable[Dict]) -> Dict:
    """The census of the counter's collectives: per op its count, output
    bytes and moved bytes (the reference's keys), the moved bytes in all,
    and their time on the H100 model (``seconds``)."""
    ops: Dict[str, Dict] = {}
    total = seconds = 0.0
    groups = []
    for e in entries:
        moved = moved_bytes(e["op"], e["out_bytes"], e["group_size"])
        d = ops.setdefault(e["op"], {"count": 0, "out_bytes": 0,
                                     "moved_bytes": 0.0})
        d["count"] += e["count"]
        d["out_bytes"] += e["out_bytes"]
        d["moved_bytes"] += moved
        total += moved
        bw = NVLINK_BW if e["intra_node"] else IB_BW
        seconds += moved / bw
        groups.append(dict(e, moved_bytes=moved, link="nvlink"
                           if e["intra_node"] else "infiniband"))
    return {"ops": ops, "moved_bytes_per_device": total, "seconds": seconds,
            "groups": groups}


def roofline_terms(artifact: Dict) -> Dict:
    """The three roofline terms (seconds) of a dry-run artifact, per rank:
    compute at the bf16 peak, memory at HBM's rate, collectives at their
    links' rates; the dominant one; model FLOPs over the counted FLOPs of
    all ranks; and the share of the bf16 peak the model FLOPs would reach
    if the step took exactly its bound (the terms fully overlapped)."""
    flops_dev = artifact["cost"].get("flops_per_device") or 0.0
    bytes_dev = artifact["cost"].get("bytes_per_device") or 0.0
    coll = artifact["collectives"]
    n = artifact["n_chips"]
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll.get("seconds", coll["moved_bytes_per_device"] / IB_BW)
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    model_flops = artifact.get("model_flops_global") or 0.0
    counted_global = flops_dev * n
    useful = model_flops / counted_global if counted_global else 0.0
    bound_s = max(compute_s, memory_s, collective_s)
    frac = (model_flops / n / PEAK_FLOPS) / bound_s if bound_s else 0.0
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "model_flops_over_counted_flops": useful,
            "roofline_fraction": frac}


def step_share_of_peak(model_flops: float, step_s: float) -> float:
    """A measured step's share of the card's bf16 peak: model FLOPs over
    (step time x 989e12)."""
    return model_flops / (step_s * PEAK_FLOPS) if step_s else 0.0
