"""Plain reference of the paper's PSVGP training step (arXiv:2507.16771,
§4: eq. 3's ELBO per cell, the delta-weighted neighbour sampler of eq. 8/9,
Adam), in float32 PyTorch with TF32 off.

It imports nothing of the program and takes nothing the program made: from
the raw field it bins the points into the grid's cells and pads their
storage, builds the neighbour table and the slot probabilities, draws the
initial state and every step's mini-batches, and takes the steps. What it
must share with the program to follow it step by step is the definition of
the draws, which are part of the algorithm as the program states it: the
counter-based SplitMix64 uniforms of (seed, step, draw, element), a
Gumbel-max slot, the top-B of uniform scores for the rows, and inducing
points drawn as the top-m of ``torch.rand`` from a generator seeded from
the seed.

``precision="tf32"`` is the control: every matrix product rounds its
operands to TF32's 10 bits of mantissa, as the tensor cores do when TF32
is allowed.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

LEAVES = ("m_star", "s_tril", "z", "log_lengthscale", "log_variance", "log_beta")
LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------- draws


def stream_seed(seed: int, stream: str, step: int = 0) -> int:
    digest = hashlib.blake2b(f"{stream}:{int(seed)}:{int(step)}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def _signed(c: int) -> int:
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


GOLDEN = _signed(0x9E3779B97F4A7C15)
MIX1 = _signed(0xBF58476D1CE4E5B9)
MIX2 = _signed(0x94D049BB133111EB)
DRAW = _signed(0xD1B54A32D192ED03)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ _shr(z, 30)) * MIX1
    z = (z ^ _shr(z, 27)) * MIX2
    return z ^ _shr(z, 31)


class Uniforms:
    """The k-th call of :meth:`next` in step t draws element i as the top 24
    bits of SplitMix64 at counter (i + 1) from a start mixing (seed, t, k)."""

    def __init__(self, seed: int, step: int, device):
        self.device = device
        base = torch.tensor(_signed(step * GOLDEN + stream_seed(seed, "step")),
                            dtype=torch.int64, device=device)
        self.start = splitmix64(base)
        self.k = 0

    def next(self, shape: tuple) -> torch.Tensor:
        n = math.prod(shape)
        start = self.start + _signed(self.k * DRAW)
        self.k += 1
        ctr = torch.arange(1, n + 1, dtype=torch.int64, device=self.device) * GOLDEN
        bits = _shr(splitmix64(ctr + start), 40)
        return (bits.to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)


# ---------------------------------------------------------------- grid


def partition(x: np.ndarray, y: np.ndarray, gx: int, gy: int, pad_multiple: int):
    """The points binned into a gx x gy grid over their bounding box (upper
    edges nudged by 1e-6 of the extent so the largest coordinate falls in
    the last cell), cell index iy * gx + ix, each cell's points in data
    order, padded to the largest count rounded up to ``pad_multiple``;
    padded rows repeat the cell's first point with mask 0.

    Returns numpy (xs (P, n, d), ys (P, n), mask (P, n), counts (P,))."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    cells = []
    for k, g in enumerate((gx, gy)):
        lo, hi = float(x[:, k].min()), float(x[:, k].max())
        hi += 1e-6 * max(hi - lo, 1.0)
        edges = np.linspace(lo, hi, g + 1)
        cells.append(np.clip(np.searchsorted(edges, x[:, k], side="right") - 1, 0, g - 1))
    cell = cells[1] * gx + cells[0]
    P, d = gx * gy, x.shape[1]
    order = np.argsort(cell, kind="stable")  # by cell, data order within one
    bounds = np.searchsorted(cell[order], np.arange(P + 1))
    members = [order[bounds[p]:bounds[p + 1]] for p in range(P)]
    counts = np.array([len(r) for r in members])
    n = -(-int(counts.max()) // pad_multiple) * pad_multiple
    xs = np.zeros((P, n, d), np.float32)
    ys = np.zeros((P, n), np.float32)
    mask = np.zeros((P, n), np.float32)
    for p, rows in enumerate(members):
        if len(rows):
            xs[p] = x[rows[0]]
            xs[p, :len(rows)] = x[rows]
            ys[p, :len(rows)] = y[rows]
            mask[p, :len(rows)] = 1.0
    return xs, ys, mask, counts


def neighbours(gx: int, gy: int) -> np.ndarray:
    """(P, 5) [self, east, west, north, south], -1 off the grid (no wrap)."""
    out = np.full((gx * gy, 5), -1, np.int64)
    for iy in range(gy):
        for ix in range(gx):
            p = iy * gx + ix
            out[p, 0] = p
            if ix + 1 < gx:
                out[p, 1] = p + 1
            if ix > 0:
                out[p, 2] = p - 1
            if iy + 1 < gy:
                out[p, 3] = p + gx
            if iy > 0:
                out[p, 4] = p - gx
    return out


def slot_probs(counts: torch.Tensor, table: torch.Tensor, delta: float):
    """eq. (9): weights n_j for the cell itself, delta n_k for each neighbour;
    (probabilities (P, 5), n_eff (P,))."""
    n_k = counts[table.clamp_min(0)].to(torch.float32) * (table >= 0)
    scale = torch.tensor([1.0] + [float(delta)] * 4, dtype=torch.float32, device=counts.device)
    w = n_k * scale
    n_eff = w.sum(dim=1)
    return w / n_eff.clamp_min(1e-12)[:, None], n_eff


# ---------------------------------------------------------------- model


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10-bit mantissa."""
    b = t.contiguous().view(torch.int32)
    r = (b + 0xFFF + ((b >> 13) & 1)) & -8192
    return r.view(torch.float32)


def matmul(precision: str):
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        def mm(a, b):
            ra = a + (to_tf32(a.detach()) - a).detach()
            rb = b + (to_tf32(b.detach()) - b).detach()
            return torch.matmul(ra, rb)
        return mm
    raise ValueError(precision)


def rbf(x, z, log_l, log_var):
    """ARD squared exponential, by the explicit difference: (P, n, m)."""
    inv = torch.exp(-log_l)[:, None, :]
    diff = (x * inv)[:, :, None, :] - (z * inv)[:, None, :, :]
    return torch.exp(log_var)[:, None, None] * torch.exp(-0.5 * (diff * diff).sum(-1))


def neg_elbo(p: dict, bx, by, bm, n_eff, jitter: float, mm) -> torch.Tensor:
    """-eq. (3) of every cell on its mini-batch: (P,)."""
    m = p["z"].shape[1]
    eye = torch.eye(m, dtype=torch.float32, device=bx.device)
    kmm = rbf(p["z"], p["z"], p["log_lengthscale"], p["log_variance"]) + jitter * eye
    chol = torch.linalg.cholesky_ex(kmm).L
    knm = rbf(bx, p["z"], p["log_lengthscale"], p["log_variance"])
    # the projection as the kernel states it: W = L^-1, then K_nm W^T
    w = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    lk = mm(knm, w.mT).mT  # (P, m, B): L^-1 k_i
    a = torch.linalg.solve_triangular(chol.mT, lk, upper=True)  # K_mm^-1 k_i
    s_half = torch.tril(p["s_tril"], -1) + torch.diag_embed(
        torch.exp(torch.diagonal(p["s_tril"], dim1=-2, dim2=-1)))
    fmean = mm(a.mT, p["m_star"][:, :, None])[:, :, 0]
    sa = mm(s_half.mT, a)
    fvar = torch.exp(p["log_variance"])[:, None] - (lk * lk).sum(1) + (sa * sa).sum(1)
    fvar = fvar.clamp_min(1e-12)
    beta = torch.exp(p["log_beta"])[:, None]
    ll = (0.5 * p["log_beta"][:, None] - 0.5 * LOG_2PI - 0.5 * beta * (by - fmean) ** 2
          - 0.5 * beta * fvar) * bm
    expected = n_eff / bm.sum(1).clamp_min(1.0) * ll.sum(1)
    l_s = torch.linalg.solve_triangular(chol, s_half, upper=False)
    l_m = torch.linalg.solve_triangular(chol, p["m_star"][:, :, None], upper=False)
    kl = 0.5 * ((l_s * l_s).sum((1, 2)) + (l_m * l_m).sum((1, 2)) - m
                + 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(1)
                - 2.0 * torch.diagonal(p["s_tril"], dim1=-2, dim2=-1).sum(1))
    return kl - expected


def init(seed: int, cfg: dict, xs: torch.Tensor, mask: torch.Tensor) -> dict:
    """Inducing points: the top-m of ``torch.rand`` scores over each cell's
    valid rows, from a generator seeded with the "init" stream of ``seed``;
    m* = 0, S = I, the covariance and noise at their initial values."""
    P, _, d = xs.shape
    m, dev = int(cfg["num_inducing"]), xs.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(stream_seed(seed, "init"))
    scores = torch.rand(mask.shape, generator=gen, device=dev) + (mask - 1.0) * 1e9
    idx = torch.topk(scores, m, dim=1).indices
    return {
        "m_star": torch.zeros((P, m), device=dev),
        "s_tril": torch.zeros((P, m, m), device=dev),
        "z": torch.gather(xs, 1, idx[:, :, None].expand(P, m, d)).clone(),
        "log_lengthscale": torch.full((P, d), math.log(cfg["init_lengthscale"]), device=dev),
        "log_variance": torch.full((P,), math.log(cfg["init_variance"]), device=dev),
        "log_beta": torch.full((P,), math.log(cfg["init_beta"]), device=dev),
    }


def minibatch(seed: int, step: int, probs, table, xs, ys, mask, batch: int):
    """Step ``step``'s draws: each cell's source slot by Gumbel-max over
    log p, then B rows of the source as the top-B of uniform scores (padded
    rows pushed below every valid one). Returns (bx, by, bm)."""
    draws = Uniforms(seed, step, xs.device)
    u = draws.next(tuple(probs.shape)).clamp_min(torch.finfo(torch.float32).tiny)
    slot = torch.argmax(torch.log(probs.clamp_min(1e-30)) - torch.log(-torch.log(u)), dim=1)
    source = table.gather(1, slot[:, None])[:, 0]
    src_mask = mask[source]
    scores = draws.next(tuple(src_mask.shape)) + (src_mask - 1.0) * 1e9
    rows = torch.topk(scores, batch, dim=1).indices
    return (xs[source[:, None], rows], ys[source[:, None], rows], mask[source[:, None], rows])


def follow(x: np.ndarray, y: np.ndarray, cfg: dict, mix: dict, init_seed: int, draw_seed: int,
           steps: int, device, precision: str = "float32") -> dict:
    """Take ``steps`` SGD steps from the initial state of ``init_seed`` with
    the draws of ``draw_seed``. Returns float64 CPU tensors by leaf: the
    first step's gradient ``grad1``, the parameters at the start ``p0`` and
    after the last step ``p_end``."""
    gx, gy = mix["grid"]
    xs, ys, mask, counts = partition(x, y, gx, gy, int(mix["pad_multiple"]))
    xs, ys, mask = (torch.as_tensor(a, device=device) for a in (xs, ys, mask))
    table = torch.as_tensor(neighbours(gx, gy), device=device)
    probs, n_eff = slot_probs(torch.as_tensor(counts, device=device), table, cfg["delta"])
    mm = matmul(precision)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = precision == "tf32"
    try:
        return _steps(xs, ys, mask, table, probs, n_eff, cfg, init_seed, draw_seed, steps, mm)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _steps(xs, ys, mask, table, probs, n_eff, cfg, init_seed, draw_seed, steps, mm) -> dict:
    device = xs.device
    b1, b2, eps = (float(cfg["adam"][k]) for k in ("b1", "b2", "eps"))
    lr = float(cfg["learning_rate"])

    params = init(init_seed, cfg, xs, mask)
    p0 = {k: v.detach().double().cpu() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    grad1 = None
    for t in range(steps):
        bx, by, bm = minibatch(draw_seed, t, probs, table, xs, ys, mask, int(cfg["batch_size"]))
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss = neg_elbo(leaves, bx, by, bm, n_eff, float(cfg["jitter"]), mm).sum()
            grads = dict(zip(LEAVES, torch.autograd.grad(loss, [leaves[k] for k in LEAVES]),
                             strict=True))
        if grad1 is None:
            grad1 = {k: g.double().cpu() for k, g in grads.items()}
        count = torch.tensor(float(t + 1), device=device)
        c1, c2 = 1.0 - b1**count, 1.0 - b2**count
        with torch.no_grad():
            for k in LEAVES:
                g = grads[k]
                mu[k] = b1 * mu[k] + (1.0 - b1) * g
                nu[k] = b2 * nu[k] + (1.0 - b2) * (g * g)
                params[k] = params[k] - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
    return {"grad1": grad1, "p0": p0, "p_end": {k: v.double().cpu() for k, v in params.items()}}
