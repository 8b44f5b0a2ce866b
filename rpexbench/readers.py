"""What the metric readers share: the window's rates, the kernels' device
seconds by name, and their roofline bounds from the frozen costs
(``costs/``) at the shapes of the cell's configuration and mix.  Every
model call of a cell runs at the mix's batch and sequence length."""
from __future__ import annotations

import re

from .costs import flash_bwd, flash_fwd, model_flops, ssd_chunk, ssd_chunk_bwd
from .costs.peaks import BF16_FLOPS, bound_s

K2 = r"\bssd_chunk_\w*kernel"
K2B = r"\bssd_bwd_\w*kernel"
K1 = r"\bflash_fwd_\w*kernel"
K1B = r"\bflash_bwd_\w*kernel"


def rate(rec, kind):
    """Tokens a second over the window: the tokens of the work finished in
    it over the span from its start to the end of that work."""
    if rec["kind"] != kind or not rec.get("span_s"):
        return None
    return rec["tokens"] / rec["span_s"]


def mfu(rec, kind, training):
    r = rate(rec, kind)
    if r is None:
        return None
    return 100.0 * r * model_flops.per_token(rec["model"], training) / BF16_FLOPS


def kernel_seconds(rec, pattern):
    tr = rec.get("trace")
    if not tr:
        return 0.0
    return sum(s for n, s in tr["kernels"].items() if re.search(pattern, n))


def roofline_pct(rec, parts):
    """100 x the summed bounds of every call of each (launch counter,
    cost) in ``parts`` over the summed device seconds of the kernels
    matching the patterns: None where no call ran or none was traced."""
    tr = rec.get("trace")
    if not tr:
        return None
    bound, spent = 0.0, 0.0
    for counter, pattern, cost in parts:
        calls = tr["launches"].get(counter, 0)
        if calls:
            bound += calls * bound_s(*cost)
            spent += kernel_seconds(rec, pattern)
    if bound == 0.0 or spent == 0.0:
        return None
    return 100.0 * bound / spent


def ssd_costs(rec):
    m, sh = rec["model"], rec["shape"]
    inner = m.get("d_inner") or 2 * m["d_model"]
    dims = (sh["batch"], sh["seq"], inner // m["ssm_head_dim"],
            m["ssm_head_dim"], m["ssm_state"], m["ssm_chunk"])
    return ssd_chunk.cost(*dims), ssd_chunk_bwd.cost(*dims)


def flash_costs(rec):
    """K1's and K1b's cost of one call: causal self-attention over the
    sequence (K1's f32 log-sum-exp, written by the training calls and not
    by evaluation's, left out of its bytes: K1 is bound by its
    operations)."""
    m, sh = rec["model"], rec["shape"]
    dims = (sh["batch"], sh["seq"], sh["seq"], m["num_heads"],
            m["num_kv_heads"], m["head_dim"])
    return flash_fwd.cost(*dims), flash_bwd.cost(*dims)


def idle_pct(rec, kind):
    tr = rec.get("trace")
    if rec["kind"] != kind or not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mean(xs):
    return sum(xs) / len(xs) if xs else None
