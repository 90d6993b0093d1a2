"""Plain-torch oracle for minibatch SGD on GLMs (paper Algorithm 3), over
K hyper-parameter jobs at once — the plain version of the SGD kernel.

Loss: ridge regression (J = 1/2 (<x,a> - b)^2) or logistic regression
(sigmoid link), both with optional L2.  Semantics match the kernel: mean
gradient over each minibatch (divided by the nominal minibatch), model
updated once per minibatch (the RAW dependency the paper preserves),
dataset scanned in order for N epochs.

Each job is trained on its own, one minibatch at a time, in the
reference's order of operations, so a job's weights do not depend on
which other jobs share the call (a batched product over jobs could sum
in another order for another job count).
"""
from __future__ import annotations

import torch

LOG_EPS = 1e-7


def _link(kind: str, z: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(z) if kind == "logreg" else z


def sgd_ref(a: torch.Tensor, b: torch.Tensor, xs0: torch.Tensor,
            lrs: torch.Tensor, l2s: torch.Tensor, *, minibatch: int = 16,
            epochs: int = 1, kind: str = "ridge") -> torch.Tensor:
    """a (m, n) f32, b (m,), xs0 (K, n), lrs (K,), l2s (K,) -> trained
    xs (K, n).  ``m`` must be a multiple of ``minibatch``."""
    m = a.shape[0]
    if m % minibatch:
        raise ValueError(f"{m} rows are not a multiple of the minibatch "
                         f"{minibatch}")
    nb = m // minibatch
    out = []
    for x, lr, l2 in zip(xs0, lrs.tolist(), l2s.tolist()):
        two_l2 = 2.0 * l2            # exact: the reference's 2.0 * l2
        for _ in range(epochs):
            for i in range(nb):
                ai = a[i * minibatch:(i + 1) * minibatch]
                bi = b[i * minibatch:(i + 1) * minibatch]
                z = ai @ x                                   # Dot
                d = _link(kind, z) - bi                      # ScalarEngine
                g = ai.T @ d / minibatch                     # Update
                x = x - lr * (g + two_l2 * x)                # RAW kept
        out.append(x)
    return torch.stack(out) if out else xs0.clone()


def loss_terms(a: torch.Tensor, b: torch.Tensor, xs: torch.Tensor,
               kind: str) -> torch.Tensor:
    """Per-row loss terms (m, K) of K models, without the L2 term."""
    z = a @ xs.T
    bb = b[:, None]
    if kind == "logreg":
        p = torch.sigmoid(z)
        return -(bb * torch.log(p + LOG_EPS)
                 + (1 - bb) * torch.log(1 - p + LOG_EPS))
    return 0.5 * torch.square(z - bb)


def loss_ref(a: torch.Tensor, b: torch.Tensor, xs: torch.Tensor,
             l2s: torch.Tensor, *, kind: str = "ridge") -> torch.Tensor:
    """Mean loss over the rows plus each model's L2 term: (K,)."""
    return loss_terms(a, b, xs, kind).mean(dim=0) \
        + l2s * torch.square(xs).sum(dim=1)
