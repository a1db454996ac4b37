"""Brute-force nearest neighbour (k = 1).

Port of ``moco_flow_tpu/ops/knn.py``: the nearest SMPL vertex of each query
point, by the expansion |q - v|^2 = |q|^2 - 2 q.v + |v|^2. The argmin is
taken over |v|^2 - 2 q.v, then |q|^2 is added to the minimum and the root
taken, exactly as the JAX function does: another formula (``torch.cdist``)
rounds differently and can flip a nearest vertex or the ``inside``
threshold. The (chunk, 3) x (3, V) product is a plain fp32 matmul outside
any kernel, as JAX leaves it to XLA; it must not run in TF32.
"""

from __future__ import annotations

import torch


def nearest_neighbor(refs: torch.Tensor, queries: torch.Tensor,
                     chunk: int = 8192):
    """(V, 3) reference points, (Q, 3) queries -> (dist, idx), each (Q,):
    the Euclidean distance to and the index of the nearest reference point,
    in chunks of ``chunk`` queries."""
    ref_sq = torch.sum(refs * refs, dim=-1)
    dists, idxs = [], []
    for i in range(0, queries.shape[0], chunk):
        q = queries[i:i + chunk]
        d2 = ref_sq[None, :] - 2.0 * (q @ refs.T)
        idx = torch.argmin(d2, dim=-1)            # the first of ties
        best = torch.gather(d2, 1, idx[:, None])[:, 0]
        q_sq = torch.sum(q * q, dim=-1)
        dists.append(torch.sqrt(torch.clamp(best + q_sq, min=0.0)))
        idxs.append(idx)
    return torch.cat(dists), torch.cat(idxs)
