"""Faults planted in the program, for the check's own tests and for the
readings that set the check's limits (``calibrate.py``): each must make a
run's ``correct`` come out false.

* ``unchanged_step``: the training step returns its state unchanged;
* ``half_batch``: half of every mini-batch left out, the ELBO's mean taken
  over the rest (the mask of the batch's second half zeroed);
* ``altered_answer``: the projection's answer altered where it is produced,
  as a kernel whose loop stops one inducing point short would leave it.

A cell on one chip has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def unchanged_step():
    from repro_torch.core import psvgp

    def make(original):
        def train_step(static, state, data, seed=None):
            return state, torch.zeros((), device=data.x.device)
        return train_step

    return _patched(psvgp, "train_step", make)


def half_batch():
    from repro_torch.core import psvgp

    def make(original):
        def gather_minibatch(x, y, mask, kprime, idx):
            bx, by, bm = original(x, y, mask, kprime, idx)
            keep = torch.ones_like(bm)
            keep[:, bm.shape[1] // 2:] = 0.0
            return bx, by, bm * keep
        return gather_minibatch

    return _patched(psvgp, "gather_minibatch", make)


def altered_answer():
    from repro_torch.kernels import ops

    def make(original):
        def svgp_projection(x, z, log_lengthscale, log_variance, lmm):
            knm, lk_t, q_diag = original(x, z, log_lengthscale, log_variance, lmm)
            last = lk_t[..., -1]
            short = torch.cat([lk_t[..., :-1], torch.zeros_like(last)[..., None]], dim=-1)
            return knm, short, q_diag - last * last
        return svgp_projection

    return _patched(ops, "svgp_projection", make)


FAULTS = {"unchanged_step": unchanged_step, "half_batch": half_batch,
          "altered_answer": altered_answer}
