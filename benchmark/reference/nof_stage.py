"""The plain reference of one MoCo-Flow stage-2 training step (the NoF
pretraining of ``init_nof.yaml``).

Plain PyTorch in float32, written from the published stage: a step takes
one frame, ``N_sampled`` points uniform in the cube of half extent 1.5 and
``N_sampled`` near-surface points (vertices picked at random, moved by
N(0, 0.1) noise); each point's nearest posed vertex maps it to the
canonical frame through that vertex's src -> canonical 4x4; the bw NoF
warps the queries and the fw NoF the canonical points, both at the frame's
normalized index; the loss is the bidirectional L1, mean|bw(q) - cano| +
mean|fw(cano) - q|; autograd, then Adam. The NoF, its encoding and Adam
are ``model.py``'s, which the stage-3 reference uses too. No kernel, no
re-chunking into rays, no expansion of the distance.

Departures from the published description:

- the nearest vertex is found in float64 (the program's KNN is float32),
  in blocks of queries so that the differences fit beside the program on
  the card; the canonical point is then taken in the step's precision;
- the frames are the benchmark's synthetic body (24 rigid parts), not SMPL:
  a vertex's chain is its part's, so the same formula is run;
- the learning rate is the schedule's first: the benchmark's steps lie far
  below ``decay_step``.

It imports nothing of the program under test. Its inputs are the
benchmark's: the body's tables, the weights and each step's draws.
"""

from __future__ import annotations

import torch

from .model import Adam, _cast, _copy, leaves, nearest, nof

THICKNESS = 0.1          # the near-surface points' noise (NoFDataset's)
BLOCK_BYTES = 1 << 30    # float64 differences of one block of queries


def model_dims(cfg: dict) -> dict:
    """The NoFs' encodings, widths and skips, as ``model.nof`` takes them."""
    mc = cfg["model"]
    nc = mc["bw_NoF"]

    def freqs(key):
        return (mc.get(key) or {}).get("N_freqs", 0)

    return {"nof_xyz_freqs": freqs("nof_embedding_xyz"),
            "nof_ind_freqs": freqs("nof_embedding_ind"),
            "nof_in_xyz": nc["in_channels_xyz"],
            "nof_in_ind": nc["extra_feat_dim"],
            "nof_skips": tuple(nc["skips"])}


def nearest_blocked(verts: torch.Tensor, q: torch.Tensor,
                    rows: int | None = None):
    """``model.nearest`` (float64) over blocks of ``rows`` queries, by
    default as many as keep a block's (rows, V, 3) differences within
    ``BLOCK_BYTES``: each query's answer is its own block's."""
    rows = rows or max(1, BLOCK_BYTES // (24 * verts.shape[0]))
    parts = [nearest(verts, q[i:i + rows]) for i in range(0, q.shape[0],
                                                          rows)]
    return torch.cat([d for d, _ in parts]), torch.cat([i for _, i in parts])


def correspondences(body: dict, draws: dict):
    """The step's queries (2N, 3), their canonical points (2N, 3) and each
    query's nearest vertex (2N,)."""
    f = draws["frame"]
    verts = body["verts"][f]
    q = torch.cat([draws["cube"],
                   verts[draws["pick"]] + draws["noise"] * THICKNESS])
    _, idx = nearest_blocked(verts, q)
    homo = torch.cat([q, torch.ones_like(q[:, :1])], -1)
    cano = (body["src_to_cano"][f][idx] @ homo[:, :, None])[:, :3, 0]
    return q, cano, idx


def losses(params: dict, body: dict, draws: dict, m: dict) -> dict:
    """The two L1 terms of one step."""
    q, cano, _ = correspondences(body, draws)
    ind = body["norm_idx"][draws["frame"]].reshape(1, 1)
    bw = nof(params["bw_NoF"], q[None], ind, m)[0]
    fw = nof(params["fw_NoF"], cano[None], ind, m)[0]
    return {"nof_bw": (bw - cano).abs().mean(),
            "nof_fw": (fw - q).abs().mean()}


def param_tree(cfg: dict, device) -> dict:
    """Zero parameters of the bw and fw NoF (layers, head), each layer
    ``{'w': (in, out), 'b': (out,)}``, in the order the benchmark fills
    them from the seed."""
    def lin(i, o):
        return {"w": torch.zeros((i, o), device=device),
                "b": torch.zeros((o,), device=device)}

    def nof_tree(nc):
        d, w = nc["D"], nc["W"]
        x = nc["in_channels_xyz"] + nc["extra_feat_dim"]
        return {"layers": [lin((x if i == 0 else w)
                               + (x if i in nc["skips"] else 0), w)
                           for i in range(d)],
                "head": lin(w, 9 if nc.get("use_quat", True) else 3)}

    mc = cfg["model"]
    return {"bw_NoF": nof_tree(mc["bw_NoF"]), "fw_NoF": nof_tree(mc["fw_NoF"])}


def run_steps(cfg: dict, params: dict, body: dict, draws_list: list,
              dtype=torch.float32) -> dict:
    """The reference's steps from ``params`` (copied here in ``dtype``) on
    each step's draws (``frame``, ``cube``, ``pick``, ``noise``). Returns
    the total loss and the loss terms of each step, the first step's
    gradient of each leaf and the parameters after the last step. ``dtype``
    float64 gives a witness of the float32 reference's own rounding."""
    m = model_dims(cfg)
    opt_cfg = cfg["optimizer"]
    if opt_cfg["type"] != "adam" or opt_cfg.get("weight_decay"):
        raise ValueError("the reference has Adam without weight decay only")
    if any(int(s) <= len(draws_list)
           for s in (cfg.get("scheduler") or {}).get("decay_step", [])):
        raise ValueError("a learning-rate milestone within the steps")
    tree = _copy(params, dtype)
    body, draws_list = _cast(body, dtype), _cast(draws_list, dtype)
    named = leaves(tree)
    for t in named.values():
        t.requires_grad_(True)
    opt = Adam(list(named.values()), float(opt_cfg["lr"]))
    out = {"losses": [], "terms": [], "first_grad": None}
    for draws in draws_list:
        terms = losses(tree, body, draws, m)
        total = sum(terms.values())
        grads = torch.autograd.grad(total, list(named.values()))
        if out["first_grad"] is None:
            out["first_grad"] = {k: g.detach().clone()
                                 for k, g in zip(named, grads)}
        opt.step(list(grads))
        out["losses"].append(float(total.detach()))
        out["terms"].append({k: float(v.detach()) for k, v in terms.items()})
    out["params"] = {k: t.detach().clone() for k, t in named.items()}
    return out
