"""What the references share: the precision a run computes in, RMSNorm,
the chunked cross-entropy, AdamW with its cosine schedule, and the
training and scoring drivers over a family's ``layer`` and ``head``.

Every tensor is float32 and every matrix product is float32 with TF32 off
(:func:`no_tf32`).  ``Precision("fp8")`` is the control: the operands of
each of the model's matrix products (projections, MLP, head) rounded to
float8 e4m3 with one scale a tensor, as an fp8 matmul takes them, and the
product accumulated in float32; the rounding passes gradients straight
through.  Parameters are held as the configuration states them: values of
its ``dtype`` (bfloat16), updated by AdamW in float32 and rounded back to
that type after each step, with float32 moments.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

F8_MAX = 448.0              # the largest finite float8 e4m3 value


class Precision:
    """``"f32"`` or ``"fp8"``: how the operands of a matrix product are
    rounded before the float32 product."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def round(self, t):
        if self.name == "f32":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / F8_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (q - t.detach())

    def mm(self, a, b):
        return self.round(a) @ self.round(b)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms_norm(x, w, eps):
    """x / rms(x) * (1 + w): the scale is stored as a delta from 1."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def leaf_dims(m: dict):
    """(d_model, vocab) of a configuration's ``model`` sizes."""
    return m["d_model"], m["vocab_size"]


def head_leaves(m: dict):
    """The embedding, the final norm and an untied head: (path, shape,
    init) as :mod:`rpexbench.weights` draws them."""
    d, V = leaf_dims(m)
    out = [("embed", (V, d), ("normal", V)), ("final_norm", (d,), ("zeros",))]
    if not m.get("tie_embeddings", False):
        out.append(("lm_head", (d, V), ("normal", d)))
    return out


def logits(m, params, h, prec):
    head = params["embed"].t() if m.get("tie_embeddings") else params["lm_head"]
    return prec.mm(h, head)


def _xent(m, params, h, targets, prec):
    lg = logits(m, params, h, prec)
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, targets[..., None])[..., 0]
    return (logz - gold).sum()


def loss(fam, m, params, tokens, targets, prec, *, chunk: int = 1024):
    """Mean next-token cross-entropy of ``tokens`` (B, S) against
    ``targets``: each layer under a checkpoint (recomputed in the
    backward), the head and loss over ``chunk`` positions at a time."""
    x = params["embed"][tokens]
    for i in range(m["num_layers"]):
        if torch.is_grad_enabled():
            x = checkpoint(fam.layer, m, params, i, x, prec,
                           use_reentrant=False)
        else:
            x = fam.layer(m, params, i, x, prec)
    h = rms_norm(x, params["final_norm"], m["norm_eps"])
    total = 0.0
    for c in range(0, h.shape[1], chunk):
        args = (m, params, h[:, c:c + chunk], targets[:, c:c + chunk], prec)
        total = total + (checkpoint(_xent, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _xent(*args))
    return total / targets.numel()


@torch.no_grad()
def last_logits(fam, m, params, tokens, prec):
    """The last position's logits (B, V) of a forward over ``tokens``."""
    x = params["embed"][tokens]
    for i in range(m["num_layers"]):
        x = fam.layer(m, params, i, x, prec)
    h = rms_norm(x[:, -1:], params["final_norm"], m["norm_eps"])
    return logits(m, params, h, prec)[:, 0]


def cosine_lr(step: int, base: float, warmup: int, total: int) -> float:
    """The learning rate of ``step`` (1-based), in float32 as the
    configuration's schedule computes it."""
    s = torch.tensor(float(step), dtype=torch.float32)
    if step < warmup:
        return float(base * s / max(1, warmup))
    prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    return float(0.5 * base * (1.0 + torch.cos(math.pi * prog)))


class AdamW:
    """AdamW with global-norm clipping, bias correction and decoupled decay
    on matrices and on every leaf of a layer; moments in float32, each
    parameter rounded back to its stored type (``stores``, by path) after
    the update."""

    def __init__(self, opt: dict, stores: dict):
        self.o, self.stores, self.step = opt, stores, 0

    def init(self, params):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params, grads):
        o = self.o
        self.step += 1
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = cosine_lr(self.step, o["lr"], o["warmup"], o["total"])
        b1, b2 = o["b1"], o["b2"]
        bc1 = 1.0 - b1 ** self.step
        bc2 = 1.0 - b2 ** self.step
        for k, p in params.items():
            g = grads[k] * scale
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g.square())
            upd = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + o["eps"])
            if p.dim() >= 2 or k.startswith("layers."):
                upd = upd + o["weight_decay"] * p
            p.copy_((p - lr * upd).to(self.stores[k]).float())
        return float(gnorm)


def norms(tree: dict, keys):
    """Each leaf's float32 norm, in ``keys`` order, as a list of floats."""
    return torch.stack([tree[k].float().norm() for k in keys]).tolist()


def train(fam, m, params, stores, batches, held_out, opt: dict, prec,
          eval_after: int = 2):
    """Follow the program's first steps from ``params`` (path -> float32
    tensor holding values of the type ``stores`` gives for that path, in
    which the program keeps the leaf), one a batch: the loss of steps 1-3,
    each leaf's norm of the first gradient as AdamW takes it (clipped), the
    held-out loss after step ``eval_after`` and each leaf's norm of the
    change after step 3.  A batch is (tokens, targets) on the device."""
    keys = list(params)
    p0 = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    adam = AdamW(opt, stores)
    adam.init({k: v.detach() for k, v in params.items()})
    out = {"losses": [], "keys": keys}
    for i, (tokens, targets) in enumerate(batches):
        with torch.enable_grad():
            lo = loss(fam, m, params, tokens, targets, prec)
            grads = dict(zip(keys, torch.autograd.grad(
                lo, [params[k] for k in keys])))
        out["losses"].append(float(lo.detach()))
        adam.update({k: params[k].detach() for k in keys}, grads)
        del grads
        if i == 0:
            out["grad_norms"] = [n / (1 - opt["b1"])
                                 for n in norms(adam.m, keys)]
        if i == 2:
            out["change_norms"] = norms({k: params[k].detach() - p0[k]
                                         for k in keys}, keys)
            del p0
        if i + 1 == eval_after:
            with torch.no_grad():
                out["eval_loss"] = float(loss(fam, m, params, *held_out, prec))
    out["losses"] = out["losses"][:3]
    return out
