"""The plain reference of the hospital configuration: the NB and MI jobs'
count tables by ``torch.bincount`` over blocks of the staged rows, the
Naive Bayes log tables and the mutual-information statistics from them.

It imports nothing of the program.  The counts are int64 and exact; the
statistics are worked out in ``dtype`` (float64 for the reference).  The
control is the same code one step below what the configuration states:
counts summed in float32, the NB tables in float32, the MI statistics in
bfloat16 (``control_outputs``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Sequence

import numpy as np
import torch

BLOCK = 1 << 22


def pairs(num_feat: int) -> List[tuple]:
    return [(i, j) for i in range(num_feat) for j in range(i + 1, num_feat)]


def count_tables(codes: torch.Tensor, labels: torch.Tensor,
                 n_bins: Sequence[int], num_classes: int,
                 total_dtype=torch.int64, block: int = BLOCK,
                 granule: int = 0) -> Dict[str, torch.Tensor]:
    """{"class": [C], "fbc": [F, B, C], "pcc": [P, B, B, C]} over all rows,
    on the rows' device, each block counted exactly and the blocks summed
    in ``total_dtype``.  A row whose label lies outside [0, C) counts
    nowhere; a code outside [0, B) drops its cells.  With ``granule``,
    every table gains a leading axis: one table for each run of
    ``granule`` rows (the row count and ``block`` its multiples)."""
    n, f = codes.shape
    b, c = max(n_bins), num_classes
    dev = codes.device
    prs = pairs(f)
    g = granule or n
    if granule:
        assert n % g == 0 and block % g == 0, (n, block, g)
        block = min(block, n)
    lead = (n // g,) if granule else ()
    cc = torch.zeros(lead + (c,), dtype=total_dtype, device=dev)
    fbc = torch.zeros(lead + (f, b, c), dtype=total_dtype, device=dev)
    pcc = torch.zeros(lead + (len(prs), b, b, c), dtype=total_dtype,
                      device=dev)
    for start in range(0, n, block):
        ct = codes[start:start + block].t().long()              # [F, n]
        lab = labels[start:start + block].long()
        rows = lab.shape[0]
        if granule:
            first = start // g
            gran = torch.arange(rows, device=dev) // g          # [n]
            ng = -(-rows // g)
            part = lambda t: t[first:first + ng]                # noqa: E731
        else:
            gran = torch.zeros(rows, dtype=torch.long, device=dev)
            ng = 1
            part = lambda t: t.unsqueeze(0)                     # noqa: E731
        ok = (lab >= 0) & (lab < c)
        part(cc).add_(torch.bincount(gran[ok] * c + lab[ok],
                                     minlength=ng * c)
                      .view(ng, c).to(total_dtype))
        okf = ok[None, :] & (ct >= 0) & (ct < b)                # [F, n]
        for i in range(f):
            sel = okf[i]
            idx = (gran[sel] * b + ct[i][sel]) * c + lab[sel]
            part(fbc)[:, i] += torch.bincount(
                idx, minlength=ng * b * c).view(ng, b, c).to(total_dtype)
        for k, (i, j) in enumerate(prs):
            sel = okf[i] & okf[j]
            idx = ((gran[sel] * b + ct[i][sel]) * b + ct[j][sel]) * c \
                + lab[sel]
            part(pcc)[:, k] += torch.bincount(
                idx, minlength=ng * b * b * c).view(ng, b, b, c).to(
                    total_dtype)
    return {"class": cc, "fbc": fbc, "pcc": pcc}


def on_host(tables: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in tables.items()}


class JobTables:
    """The count tables of every job of a cell, each job the ``rows``
    staged rows from a start that is a multiple of ``granule`` and at
    most ``slack``.  The rows that every job reads are counted once;
    the ``slack`` rows before and after them are counted granule by
    granule, so a job's tables are the shared ones plus the granules of
    the head from its start and those of the tail up to its end."""

    def __init__(self, codes, labels, n_bins, num_classes, rows: int,
                 slack: int, granule: int, block: int = BLOCK):
        assert codes.shape[0] == rows + slack and slack <= rows
        self.granule = granule
        block = max(granule, block - block % granule)
        self.mid = count_tables(codes[slack:rows], labels[slack:rows],
                                n_bins, num_classes, block=block)
        self.head = {k: _suffix(v) for k, v in count_tables(
            codes[:slack], labels[:slack], n_bins, num_classes,
            block=block, granule=granule).items()}
        self.tail = {k: _prefix(v) for k, v in count_tables(
            codes[rows:], labels[rows:], n_bins, num_classes,
            block=block, granule=granule).items()}

    def at(self, start: int) -> Dict[str, np.ndarray]:
        """The tables of the job whose rows start at ``start``."""
        g = start // self.granule
        assert g * self.granule == start, start
        return on_host({k: self.mid[k] + self.head[k][g] + self.tail[k][g]
                        for k in self.mid})


def _suffix(t: torch.Tensor) -> torch.Tensor:
    """[G + 1, ...]: entry g sums granules g.. of ``t``; the last is 0."""
    return torch.cat([torch.flip(torch.cumsum(torch.flip(t, [0]), 0), [0]),
                      _zero(t)])


def _prefix(t: torch.Tensor) -> torch.Tensor:
    """[G + 1, ...]: entry g sums granules ..g-1 of ``t``; the first is 0."""
    return torch.cat([_zero(t), torch.cumsum(t, 0)])


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((1,) + tuple(t.shape[1:]), dtype=t.dtype,
                       device=t.device)


def nb_tables(tables, n_bins: Sequence[int], laplace: float,
              dtype=torch.float64):
    """(log prior [C], log posterior [F, B, C]): P(class), and P(bin |
    class) Laplace-smoothed over each feature's own bins (0 at bins past
    them)."""
    cc = torch.as_tensor(tables["class"]).to(dtype)
    fbc = torch.as_tensor(tables["fbc"]).to(dtype)
    f, b, _ = fbc.shape
    tiny = torch.tensor(1e-300, dtype=torch.float64).to(dtype)
    log_prior = torch.log(torch.maximum(cc, tiny) / torch.maximum(cc.sum(),
                                                                  tiny))
    valid = (torch.arange(b)[None, :] < torch.as_tensor(
        list(n_bins))[:, None])[..., None]                    # [F, B, 1]
    counts = torch.where(valid, fbc + laplace, torch.zeros_like(fbc))
    probs = torch.where(valid, counts / counts.sum(dim=1, keepdim=True),
                        torch.ones_like(counts))
    return log_prior.double().numpy(), torch.log(probs).double().numpy()


def _plogp_sum(p: torch.Tensor, dims) -> torch.Tensor:
    return (torch.where(p > 0, p * torch.log(torch.where(p > 0, p,
                                                         torch.ones_like(p))),
                        torch.zeros_like(p))).sum(dim=dims)


def entropy(counts: torch.Tensor, dims) -> torch.Tensor:
    p = counts / counts.sum(dim=dims, keepdim=True)
    return -_plogp_sum(p, dims)


def mutual_information(joint: torch.Tensor) -> torch.Tensor:
    """I(X; Y) over the last two axes of joint counts; empty cells add
    nothing."""
    p = joint / joint.sum(dim=(-2, -1), keepdim=True)
    pa = p.sum(dim=-1, keepdim=True)
    pb = p.sum(dim=-2, keepdim=True)
    ratio = torch.where(p > 0, p / (pa * pb), torch.ones_like(p))
    return (p * torch.log(ratio)).sum(dim=(-2, -1))


def mi_stats(tables, dtype=torch.float64) -> Dict[str, np.ndarray]:
    """The MI job's statistics (nats) from the count tables."""
    cc = torch.as_tensor(tables["class"]).to(dtype)
    fbc = torch.as_tensor(tables["fbc"]).to(dtype)
    pcc = torch.as_tensor(tables["pcc"]).to(dtype)
    p, b, _, c = pcc.shape
    pz = pcc.sum(dim=(1, 2)) / pcc.sum(dim=(1, 2, 3))[:, None]       # [P, C]
    cond = (pz * mutual_information(pcc.permute(0, 3, 1, 2))).sum(-1)
    out = {
        "feature_class_mi": mutual_information(fbc),
        "feature_entropy": entropy(fbc.sum(-1), -1),
        "class_entropy": entropy(cc, -1),
        "feature_pair_mi": mutual_information(pcc.sum(-1)),
        "pair_class_mi": mutual_information(pcc.reshape(p, b * b, c)),
        "pair_class_entropy": entropy(pcc.reshape(p, -1), -1),
        "feature_pair_class_cond_mi": cond,
    }
    return {k: v.double().numpy() for k, v in out.items()}


def from_tables(tables, n_bins, laplace):
    """The reference's NB log tables and MI statistics from a job's
    count tables (on the host)."""
    log_prior, log_post = nb_tables(tables, n_bins, laplace)
    return SimpleNamespace(tables=tables, log_prior=log_prior,
                           log_posterior=log_post, mi=mi_stats(tables),
                           pairs=pairs(len(n_bins)))


def reference(codes, labels, n_bins, num_classes, laplace, block=BLOCK):
    """The reference's tables, NB log tables and MI statistics over all
    of ``codes`` and ``labels``."""
    return from_tables(on_host(count_tables(codes, labels, n_bins,
                                            num_classes, block=block)),
                       n_bins, laplace)


def control_outputs(codes, labels, n_bins, num_classes, laplace,
                    block=BLOCK):
    """The control in the program's place: the reference one precision
    step down (counts summed in float32, NB in float32, MI in bfloat16),
    shaped as the program's NB model and MI result."""
    tables = on_host(count_tables(codes, labels, n_bins, num_classes,
                                  total_dtype=torch.float32, block=block))
    log_prior, log_post = nb_tables(tables, n_bins, laplace,
                                    dtype=torch.float32)
    mi = mi_stats(tables, dtype=torch.bfloat16)
    nb = SimpleNamespace(class_counts=tables["class"],
                         bin_counts=tables["fbc"], log_prior=log_prior,
                         log_posterior=log_post)
    result = SimpleNamespace(
        class_counts=tables["class"], feature_class_counts=tables["fbc"],
        pair_index=np.asarray(pairs(codes.shape[1])),
        pair_class_counts=tables["pcc"], **mi)
    return {"nb": nb, "mi": result}
