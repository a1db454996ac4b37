"""Brute-force nearest neighbour (k = 1).

Port of ``moco_flow_tpu/ops/knn.py``: the nearest SMPL vertex of each query
point, by the expansion |q - v|^2 = |q|^2 - 2 q.v + |v|^2. The argmin is
taken over |v|^2 - 2 q.v, then |q|^2 is added to the minimum and the root
taken, exactly as the JAX function does: another formula (``torch.cdist``)
rounds differently and can flip a nearest vertex or the ``inside``
threshold. The (chunk, 3) x (3, V) product is a plain fp32 matmul outside
any kernel, as JAX leaves it to XLA; it must not run in TF32, so
``allow_tf32`` is set off around it. One ``addmm`` with alpha -2 and the
|v|^2 row as its input writes the block once: -2 is a power of two, so
each element is JAX's ``|v|^2 - 2 (q.v)`` to the bit.

Queries go in chunks whose (chunk, V) block fits ``BUDGET_BYTES``: stage 2
asks for 200,000 queries against 6,890 vertices a step, 5.5 GB a block in
one piece. A BLAS library picks its kernel, and so its rounding, from the
shape (one row takes the matrix-vector path), so every launch of a call
has one shape: the queries are split into equal chunks of at least
``MIN_ROWS`` rows and the last chunk is padded with zeros.
"""

from __future__ import annotations

import contextlib

import torch

# bytes of the (chunk, V) fp32 block that a launch writes
BUDGET_BYTES = 1 << 31
# rows a launch at least: a matrix product, never the matrix-vector path
MIN_ROWS = 64


def chunk_rows(num_refs: int) -> int:
    """Queries a chunk at most, so that its distance block fits
    ``BUDGET_BYTES`` (smaller chunks only add launches)."""
    return max(MIN_ROWS, BUDGET_BYTES // (4 * max(num_refs, 1)))


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        assert not torch.backends.cuda.matmul.allow_tf32
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def nearest_neighbor(refs: torch.Tensor, queries: torch.Tensor,
                     chunk: int | None = None):
    """(V, 3) reference points, (Q, 3) queries -> (dist, idx), each (Q,):
    the Euclidean distance to and the index of the nearest reference point,
    in equal launches of at most ``chunk`` queries (default
    :func:`chunk_rows`; at least ``MIN_ROWS``)."""
    n = queries.shape[0]
    most = chunk_rows(refs.shape[0]) if chunk is None else chunk
    launches = max(1, -(-n // max(most, 1)))
    rows = max(MIN_ROWS, -(-n // launches))
    ref_sq = torch.sum(refs * refs, dim=-1)
    rt = refs.T.contiguous()                      # (3, V)
    dists, idxs = [], []
    with _no_tf32():
        for i in range(0, n, rows):
            q = queries[i:i + rows]
            if q.shape[0] < rows:                 # the launch's one shape
                q = torch.cat([q, q.new_zeros(rows - q.shape[0], 3)])
            d2 = torch.addmm(ref_sq, q, rt, alpha=-2.0)   # |v|^2 - 2 q.v
            idx = torch.argmin(d2, dim=-1)        # the first of ties
            best = torch.gather(d2, 1, idx[:, None])[:, 0]
            q_sq = torch.sum(q * q, dim=-1)
            dists.append(torch.sqrt(torch.clamp(best + q_sq, min=0.0)))
            idxs.append(idx)
    return torch.cat(dists)[:n], torch.cat(idxs)[:n]
