"""The numerics of K2b's bf16 path, rehearsed on the CPU.

``csrc/ssd_chunk_bwd.cu`` runs the SSD backward's products on bf16 tensor
cores (``mma.sync``, f32 accumulate).  x, B and C arrive in bf16 and are
exact there; every f32 operand (dy, dS, M = CB e dt, dCB summed over heads)
is split into three bf16 parts, hi + mid + lo, as ``mma::split3_bf16``
splits it.  ``split_bwd`` below repeats the kernel's arithmetic in plain
PyTorch: each product a sum of f32 products of bf16 parts (C B^T one; G =
dy x^T, U = B dS^T, V = x dS, dC = dCB B and dCB^T C three; M^T dy the
three leading cross terms of the two splits, hi hi + hi mid + mid hi, about
2^-17 relative: it feeds only dx, which is rounded to bf16), the
elementwise terms in f32 in the
kernel's order, cum and the row and column sums in f64, the sums over heads
in order.  It is held against ``ssd_chunk_bwd_plain`` with the gates
``chip_smoke.py`` holds the kernel to: each gradient within SSD_TOL (atol +
rtol) and 1e-5 normwise, bf16 dx through its one rounding; and against the
reference's VJP where that is finite, at a short chunk.

The published dt/A draw (Mamba2's init ranges, as ``mamba_smoke_params``
draws them) is taken at a seed where every 256-long chunk's decay passes 88,
where exp(cum_i - cum_j) above the diagonal is inf in f32; the test asserts
that it does.  The last tests show why three parts: the same arithmetic
with each f32 operand rounded once to bf16 misses the gate, and with two
parts it keeps less than a tenth of its normwise margin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as rref
from repro_torch.kernels.ssd import ssd_chunk_bwd_plain

SSD_TOL = 5e-4            # chip_smoke.SSD_TOL
NORM_TOL = 1e-5           # chip_smoke.SSD_BWD_NORM_TOL
REF_TOL = 1e-4            # tests/test_torch_ssd_bwd.py, against the reference
NAMES = ("dx", "ddt", "dA", "dB", "dC")
# the M^T dy product: (part of M, part of dy) for hi hi, hi mid, mid hi,
# the order the kernel issues them
MT_DY_TERMS = ((0, 0), (0, 1), (1, 0))


def parts(t, n=3):
    """t as n bf16 parts (as f32 values), hi = bf16(t), mid = bf16(t - hi),
    lo = bf16(t - hi - mid): each residue exact in f32."""
    out, r = [], t
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def mm(a_parts, b_parts, terms=None):
    """sum over the terms (i, j) of a_parts[i] @ b_parts[j] in f32; by
    default each part of a with each part of b, one side being one part."""
    if terms is None:
        terms = [(i, j) for i in range(len(a_parts)) for j in range(len(b_parts))]
    out = 0.0
    for i, j in terms:
        out = out + a_parts[i] @ b_parts[j]
    return out


def split_bwd(x, dt, A, B_, C_, dy, dS, ddall, ddch, *, chunk, n_parts=3,
              groups=1):
    """The bf16 kernel's arithmetic; n_parts=2 splits each f32 operand in
    two, n_parts=1 rounds it once to bf16 (and takes one M^T dy product).
    dCB^T and the chunk state's share of dB are summed over ``groups``
    groups of consecutive heads, heads in order within each, then the
    groups' sums in order (the kernels' kernel 2 sums two groups)."""
    Bsz, S, H, P = x.shape
    N, Q = B_.shape[-1], chunk
    nc = S // Q
    sp = lambda t: parts(t, n_parts)                          # noqa: E731
    terms = MT_DY_TERMS if n_parts > 1 else ((0, 0),)
    xq = x.float().reshape(Bsz, nc, Q, H, P).permute(0, 1, 3, 2, 4)  # b c h q p
    Bq = B_.float().reshape(Bsz, nc, Q, N)
    Cq = C_.float().reshape(Bsz, nc, Q, N)
    dtq = dt.reshape(Bsz, nc, Q, H).permute(0, 1, 3, 2)              # b c h q
    dyq = dy.reshape(Bsz, nc, Q, H, P).permute(0, 1, 3, 2, 4)
    dSq = dS.permute(0, 2, 1, 3, 4)                                  # b c h p n
    dda = ddall.permute(0, 2, 1, 3)                                  # b c h q
    ddc = ddch.permute(0, 2, 1)                                      # b c h

    cum = torch.cumsum((dtq * A[:, None]).double(), -1)              # f32 products
    low = torch.ones(Q, Q, dtype=torch.bool).tril()                  # j <= i
    diff = (cum[..., :, None] - cum[..., None, :]).float()
    e = torch.where(low, torch.exp(torch.where(low, diff, 0.0)), 0.0)
    w = torch.exp((cum[..., -1:] - cum).float()) * dtq
    cb = (Cq @ Bq.transpose(-1, -2))[:, :, None]                     # exact inputs
    g = mm(sp(dyq), [xq.transpose(-1, -2)])                          # b c h i j
    ce = cb * e
    m = ce * dtq[..., None, :]
    gm, gt = g * m, g * ce
    rs = gm.double().sum(-1)
    cs = gm.double().sum(-2)
    ts = gt.double().sum(-2)
    u = mm([Bq[:, :, None]], [p.transpose(-1, -2) for p in sp(dSq)])  # b c h q p
    dw = (xq * u).sum(-1)
    dx = w[..., None] * u + mm([p.transpose(-1, -2) for p in sp(m)], sp(dyq), terms)
    v = mm([xq], sp(dSq))                                            # b c h q n
    size = H // groups
    dcb, dB = 0.0, 0.0
    for gr in range(groups):                     # the groups' sums in order
        dcb_g, dB_g = 0.0, 0.0
        for h in range(gr * size, (gr + 1) * size):      # heads in order
            dcb_g = dcb_g + g[:, :, h] * (e[:, :, h] * dtq[:, :, h, None, :])
            dB_g = dB_g + w[:, :, h, :, None] * v[:, :, h]
        dcb, dB = dcb + dcb_g, dB + dB_g
    dB = mm([p.transpose(-1, -2) for p in sp(dcb)], [Cq]) + dB
    dC = mm(sp(dcb), [Bq])

    dcum = (rs - cs - dw.double() * w.double()
            + dda.double() * torch.exp(cum.float()).double())
    last = ddc.double() * torch.exp(cum[..., -1].float()).double() \
        + (dw.double() * w.double()).sum(-1)
    dcum[..., -1] += last
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    dA = (dtq.double() * dla).sum((0, 1, 3)).float()
    ddt = (ts + dw.double() * torch.exp((cum[..., -1:] - cum).float()).double()
           + A.double()[:, None] * dla).float()
    return (dx.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P).to(x.dtype),
            ddt.permute(0, 1, 3, 2).reshape(Bsz, S, H), dA,
            dB.reshape(Bsz, S, N), dC.reshape(Bsz, S, N))


def _xbc(B, S, H, P, N, seed):
    """x, B_, C_ in bf16 at the model's scale (silu of a unit normal), as
    split views of one (B, S, H*P + 2N) tensor."""
    rng = np.random.default_rng(seed)
    xbc = F.silu(torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * N),
                                                      np.float32)))
    xs, B_, C_ = torch.split(xbc.to(torch.bfloat16), [H * P, N, N], dim=-1)
    return xs.reshape(B, S, H, P), B_, C_


def _published_dt_a(B, S, H, seed):
    """dt = softplus(u + dt_bias), dt_bias the inverse softplus of a
    log-uniform draw in [1e-3, 0.1]; A = -U(1, 16) (Mamba2's init)."""
    rng = np.random.default_rng(seed)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
    A = -torch.from_numpy(rng.uniform(1, 16, H).astype(np.float32))
    bias = torch.from_numpy((dt0 + np.log(-np.expm1(-dt0))).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((B, S, H), np.float32))
    return F.softplus(u + bias), A


def _model_dt_a(B, S, H, seed):
    """dt and A as the reference's init makes them (tests/test_torch_gpu.py)."""
    rng = np.random.default_rng(seed)
    unif = lambda *s: torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(np.float32))  # noqa: E731
    normal = torch.from_numpy(rng.standard_normal((B, S, H), np.float32))
    return F.softplus(normal + unif(H)), -torch.exp(unif(H))


def _cotangents(B, S, H, P, N, Q, seed):
    rng = np.random.default_rng(seed)
    nc = S // Q
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            for s in ((B, S, H, P), (B, H, nc, P, N), (B, H, nc, Q), (B, H, nc))]


def _rounded_ok(got, want):
    """chip_smoke.check_rounded: each bf16 element the rounding of a value
    within SSD_TOL of want, and the norm of the error within NORM_TOL of
    rounding want itself.  Returns (elementwise ok, normwise excess)."""
    g = got.float()
    m, ex = torch.frexp(g)
    half = torch.ldexp(torch.ones_like(g), ex - 9)
    half = torch.where((m.abs() == 0.5) & (want.abs() < g.abs()), half / 2, half)
    half = torch.where(g == 0, torch.zeros_like(g), half)
    over = ((g - want).abs() - half).clamp(min=0)
    rounding = (want.to(torch.bfloat16).float() - want).norm()
    return (bool((over <= SSD_TOL + SSD_TOL * want.abs()).all()),
            float(((g - want).norm() - rounding) / want.norm()))


def _gate(got, args, cts, chunk):
    """Which gradients pass chip_smoke's K2b gate against the plain version."""
    want = ssd_chunk_bwd_plain(*args, *cts, chunk=chunk)
    dx32 = ssd_chunk_bwd_plain(*(t.float() for t in args), *cts, chunk=chunk)[0]
    ok = {}
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert bool(torch.isfinite(a).all()), name
        if name == "dx":
            elem, rel = _rounded_ok(a, dx32)
        else:
            elem = bool(((a - w).abs() <= SSD_TOL + SSD_TOL * w.abs()).all())
            rel = float((a - w).norm() / w.norm())
        ok[name] = elem and rel <= NORM_TOL
    return ok


CASES = [   # (B, S, H, P, N, chunk), draw, seed of dt/A
    ((1, 512, 2, 64, 128, 256), "published", 13),   # mamba2's head and state dims
    ((2, 512, 3, 64, 128, 256), "model", 3),
    ((1, 128, 2, 40, 20, 64), "published", 13),     # P, N not multiples of 16
    ((2, 64, 4, 32, 16, 8), "model", 4),            # jamba reduced's P, N, chunk
]


@pytest.mark.parametrize("shape,draw,seed", CASES)
def test_split_products_pass_the_kernels_gate(shape, draw, seed):
    B, S, H, P, N, Q = shape
    x, B_, C_ = _xbc(B, S, H, P, N, seed + 100)
    dt, A = (_published_dt_a if draw == "published" else _model_dt_a)(B, S, H, seed)
    if draw == "published" and Q == 256:
        decay = -(dt * A).reshape(B, S // Q, Q, H).sum(2)
        assert float(decay.min()) > 88.0     # the regime the draw is for
    args = (x, dt, A, B_, C_)
    cts = _cotangents(B, S, H, P, N, Q, seed + 200)
    got = split_bwd(*args, *cts, chunk=Q)
    assert got[0].dtype == torch.bfloat16
    assert all(_gate(got, args, cts, Q).values())


@pytest.mark.parametrize("shape,draw,seed", CASES + [
    ((1, 512, 16, 64, 128, 256), "published", 13),  # two groups of 8 heads
])
def test_grouped_head_sums_pass_the_kernels_gate(shape, draw, seed):
    """The kernels' order of the sums over heads (kernel 2 of either bf16
    route: two groups of heads, heads in order within each, then the two
    groups' sums in order; dCB^T's term G (e dt)) meets the gate."""
    B, S, H, P, N, Q = shape
    x, B_, C_ = _xbc(B, S, H, P, N, seed + 100)
    dt, A = (_published_dt_a if draw == "published" else _model_dt_a)(B, S, H, seed)
    args = (x, dt, A, B_, C_)
    cts = _cotangents(B, S, H, P, N, Q, seed + 200)
    got = split_bwd(*args, *cts, chunk=Q, groups=2 if H % 2 == 0 else 1)
    assert all(_gate(got, args, cts, Q).values())


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(1, 32, 2, 8, 4, 8),
                                             (2, 64, 4, 16, 8, 16)])
def test_split_products_match_the_reference_vjp(B, S, H, P, N, chunk):
    """At a short chunk: the split arithmetic's f32 gradients (dx before
    its rounding) within 1e-4 of the largest magnitude of each of the
    reference's VJP of its chunk terms, where that is finite (its dt and A
    are NaN in a chunk whose decay passes 88, as tests/test_torch_ssd_bwd.py
    allows)."""
    x, B_, C_ = _xbc(B, S, H, P, N, 7)
    dt, A = _model_dt_a(B, S, H, 8)
    cts = _cotangents(B, S, H, P, N, chunk, 9)
    xf, Bf, Cf = x.float(), B_.float(), C_.float()
    got = list(split_bwd(x, dt, A, B_, C_, *cts, chunk=chunk))
    # dx's f32 sum: the same arithmetic with x read as f32 (exactly)
    got[0] = split_bwd(xf, dt, A, Bf, Cf, *cts, chunk=chunk)[0]
    nc = S // chunk

    def terms(x, dt, A, B_, C_):
        y, st, dall, dch = rref.ssd_chunk_terms(
            x.reshape(B * nc, chunk, H, P), dt.reshape(B * nc, chunk, H), A,
            B_.reshape(B * nc, chunk, N), C_.reshape(B * nc, chunk, N))
        return (y.reshape(B, S, H, P),
                st.reshape(B, nc, H, P, N).swapaxes(1, 2),
                dall.reshape(B, nc, H, chunk).swapaxes(1, 2),
                dch.reshape(B, nc, H).swapaxes(1, 2))

    _, vjp = jax.vjp(terms, *(jnp.asarray(t.numpy()) for t in (xf, dt, A, Bf, Cf)))
    want = vjp(tuple(jnp.asarray(c.numpy()) for c in cts))
    for name, g, w in zip(NAMES, got, want):
        g, w = g.double().numpy(), np.asarray(w, np.float64)
        ok = np.isfinite(w)        # the reference's dt and A are NaN once a
        assert ok.all() or name in ("ddt", "dA"), name   # chunk's decay passes 88
        err = np.abs(g[ok] - w[ok]).max() / np.abs(w[ok]).max()
        assert np.isfinite(g).all() and err <= REF_TOL, (name, err)


def _mamba_case():
    B, S, H, P, N, Q = 1, 512, 2, 64, 128, 256
    x, B_, C_ = _xbc(B, S, H, P, N, 113)
    dt, A = _published_dt_a(B, S, H, 13)
    return (x, dt, A, B_, C_), _cotangents(B, S, H, P, N, Q, 213), Q


def test_unsplit_bf16_operands_miss_the_gate():
    """The gate can tell: rounding each f32 operand once to bf16 (one part,
    one M^T dy product) fails it for the gradients those products feed."""
    args, cts, Q = _mamba_case()
    ok = _gate(split_bwd(*args, *cts, chunk=Q, n_parts=1), args, cts, Q)
    assert not ok["dB"] and not ok["dC"] and not ok["ddt"], ok


def test_two_part_splits_leave_little_margin():
    """Two parts would halve most products, but the worst normwise error
    of ddt, dA, dB and dC comes within a tenth of the gate's 1e-5 (three
    parts: about 2e-7 here)."""
    args, cts, Q = _mamba_case()
    want = ssd_chunk_bwd_plain(*args, *cts, chunk=Q)
    for n_parts, lo, hi in ((3, 0.0, 1e-6), (2, 1e-6, NORM_TOL)):
        got = split_bwd(*args, *cts, chunk=Q, n_parts=n_parts)
        worst = max(float((a - w).norm() / w.norm())
                    for a, w in zip(got[1:], want[1:]))
        assert lo < worst <= hi, (n_parts, worst)
