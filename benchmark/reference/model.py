"""The plain reference of one MoCo-Flow training step (stages 1 and 3).

Plain PyTorch in float32, written from the published model: a NeRF MLP
(depth D, width W, a skip, a sigma head, an rgb branch fed a per-ray extra
feature), a pair of NoF MLPs with the log-quaternion head, sinusoidal
positional encoding laid out ``[x, sin(f_0 x)..sin(f_{K-1} x), cos(...)]``
(frequency-major blocks, the layout the model's first-layer rows are read
in), stratified and inverse-CDF depths, the NeRF quadrature, the motion
consensus terms of the local and global chains, the alpha-mask BCE of the
``msk`` phase, and the Adam and RAdam updates. Gradients come from
autograd. No kernel, no fold, no layout trick: every tensor is row-major
``(N, S, C)``, and the fine pass warps the whole sorted union of depths.

It imports nothing of the program under test. Its inputs are the
benchmark's: the scene tables, the weights and each step's draws.
"""

from __future__ import annotations

import math

import torch


def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``[x, sin(2^k x) for k, cos(2^k x) for k]`` with the sin / cos blocks
    frequency-major (column ``k*C + c``)."""
    if n_freqs == 0:
        return x
    bands = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    scaled = (x[..., None, :] * bands[:, None]).flatten(-2)
    return torch.cat([x, torch.sin(scaled), torch.cos(scaled)], dim=-1)


def embed(x: torch.Tensor, n_freqs: int, width: int) -> torch.Tensor:
    """posenc, zero-padded on the right to the layer's input width."""
    e = posenc(x, n_freqs)
    pad = width - e.shape[-1]
    return torch.nn.functional.pad(e, (0, pad)) if pad else e


def dense(layer: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ layer["w"] + layer["b"]


def nerf(p: dict, x_emb: torch.Tensor, extra: torch.Tensor | None,
         skips, sigma_only: bool = False) -> torch.Tensor:
    """The NeRF on rows: (M, in) [+ (M, E)] -> (M, 4) rgb + sigma, or (M, 1)
    sigma."""
    h = x_emb
    for i, layer in enumerate(p["trunk"]):
        if i in skips:
            h = torch.cat([x_emb, h], dim=-1)
        h = torch.relu(dense(layer, h))
    sigma = dense(p["sigma"], h)
    if sigma_only:
        return sigma
    hf = dense(p["final"], h)
    if extra is not None:
        hf = torch.cat([hf, extra], dim=-1)
    he = torch.relu(dense(p["extra"], hf))
    rgb = torch.sigmoid(dense(p["rgb"], he))
    return torch.cat([rgb, sigma], dim=-1)


def quat_rotation(v: torch.Tensor) -> torch.Tensor:
    """Log quaternion (..., 3) -> rotation matrix (..., 3, 3) of the unit
    quaternion ``(cos|v|, sin|v| v / |v|)``, for row vectors (``x @ R``)."""
    theta = torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-16)
    q = torch.cat([torch.cos(theta), v * (torch.sin(theta) / theta)], -1)
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-16)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z),
        2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z,
    ], dim=-1)
    return r.reshape(*v.shape[:-1], 3, 3)


def nof(p: dict, xyz: torch.Tensor, ind: torch.Tensor, m: dict) -> torch.Tensor:
    """Warp (N, S, 3) points of the per-ray frames ``ind`` (N, 1) through one
    NoF: ``(x - s) @ R(v) + s + t`` from the 9-wide head."""
    n, s = xyz.shape[0], xyz.shape[1]
    x_emb = embed(xyz, m["nof_xyz_freqs"], m["nof_in_xyz"])
    i_emb = embed(ind, m["nof_ind_freqs"], m["nof_in_ind"])
    inputs = torch.cat([x_emb, i_emb[:, None, :].expand(n, s, -1)], dim=-1)
    h = inputs
    for i, layer in enumerate(p["layers"]):
        if i in m["nof_skips"]:
            h = torch.cat([inputs, h], dim=-1)
        h = torch.relu(dense(layer, h))
    out = dense(p["head"], h)
    v, sh, t = out[..., 0:3], out[..., 3:6], out[..., 6:9]
    rot = quat_rotation(v)
    return ((xyz - sh)[..., None, :] @ rot)[..., 0, :] + sh + t


def stratified(near, far, n: int, u: torch.Tensor) -> torch.Tensor:
    """Jittered depths: one uniform ``u`` in each stratum between the
    midpoints of ``n`` evenly spaced depths."""
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    z = near * (1.0 - t) + far * t
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lower = torch.cat([z[:, :1], mids], -1)
    upper = torch.cat([mids, z[:, -1:]], -1)
    return lower + (upper - lower) * u


def sample_pdf(bins, weights, u, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF depths of the uniforms ``u`` (N, I) over the
    piecewise-constant pdf of ``weights`` (N, B) on ``bins`` (N, B + 1)."""
    w = weights + eps
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    denom = c1 - c0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


def composite(raw, z, dir_norm, bg, act):
    """rgb (N, 3), the weights and the alphas of one pass."""
    delta = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 1e10)], -1) * dir_norm
    alpha = 1.0 - torch.exp(-delta * act(raw[..., 3]))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    weights = alpha * trans
    rgb = (weights[..., None] * raw[..., :3]).sum(1)
    rgb = rgb + bg * (1.0 - weights.sum(1, keepdim=True))
    return rgb, weights, alpha


def masked_mean(values, mask):
    """Mean over ``mask``; the plain mean where the mask is empty."""
    if bool(mask.any()):
        return values[mask].mean()
    return values.mean()


def consensus(xyz, recon, alpha):
    """Mean |x - recon| over xyz per sample, averaged over samples whose
    alpha is at least 0.01."""
    return masked_mean((xyz - recon).abs().mean(-1), alpha >= 0.01)


def model_dims(cfg: dict) -> dict:
    """The widths and switches of a configuration's ``model`` and ``loss``
    blocks that the step needs."""
    mc, lc = cfg["model"], cfg.get("loss") or {}

    def freqs(key):
        return (mc.get(key) or {}).get("N_freqs", 0)

    nerf_cfg = mc["coarse_NeRF"]
    m = {"n_samples": mc["N_samples"], "n_importance": mc["N_importance"],
         "perturb": float(mc.get("perturb", 0.0)),
         "act": mc.get("nerf_activate_type", "relu"),
         "nerf_xyz_freqs": freqs("nerf_embedding_xyz"),
         "nerf_in_xyz": nerf_cfg["in_channels_xyz"],
         "nerf_skips": tuple(nerf_cfg["skips"]),
         "extra": nerf_cfg.get("extra_feat_type", "none"),
         "extra_dim": nerf_cfg.get("extra_feat_dim", 0),
         "extra_freqs": freqs("nerf_embedding_ind"
                              if nerf_cfg.get("extra_feat_type") == "ind"
                              else "nerf_embedding_dir"),
         "use_nof": mc["type"] == "moco_flow",
         "chain_local": bool(lc.get("chain_local", False)),
         "chain_global": bool(lc.get("chain_global", False))}
    if m["use_nof"]:
        nc = mc["bw_NoF"]
        m.update(nof_xyz_freqs=freqs("nof_embedding_xyz"),
                 nof_ind_freqs=freqs("nof_embedding_ind"),
                 nof_in_xyz=nc["in_channels_xyz"],
                 nof_in_ind=nc["extra_feat_dim"],
                 nof_skips=tuple(nc["skips"]),
                 w_img=(lc.get("img_loss") or {}).get("weight", 1.0),
                 w_local=lc.get("nof_local_weight", 0.0),
                 w_global=lc.get("nof_global_weight", 0.0),
                 w_msk=(lc.get("msk_loss") or {}).get("weight", 0.0))
    return m


def train_rays(scene: dict, draws: dict):
    """The step's rays (N, 3 + 3 + 1 + 1 + 1), target rgb and background
    from the scene tables and the draws."""
    f = draws["frame"]
    pix = scene["valid_idx"][f, draws["pixels"]]
    c2w = scene["c2w"][f]
    d = scene["directions"][pix] @ c2w[:, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = c2w[:, 3].expand(d.shape)
    raw = scene["images"][f, pix].float() / 255.0
    bg = (draws["background"].expand(d.shape[0], 3) if scene["rand_bkgd"]
          else scene["bkgd"][pix])
    a = raw[:, 3:4]
    target = raw[:, :3] * a + bg * (1.0 - a)
    ind = torch.full_like(d[:, :1], scene["norm_idx"][f].item())
    return o, d, scene["near"][f].item(), scene["far"][f].item(), ind, \
        target, bg


def warps(params, xyz, ind, chained, m):
    """The bw warp and the chains that are on, each (N, S, 3)."""
    out = {"cano": nof(params["bw_NoF"], xyz, ind, m)}
    if m["chain_local"]:
        out["recon"] = nof(params["fw_NoF"], out["cano"], ind, m)
    if m["chain_global"]:
        ch = nof(params["fw_NoF"], out["cano"], chained, m)
        out["chain_recon"] = nof(params["fw_NoF"],
                                 nof(params["bw_NoF"], ch, chained, m),
                                 ind, m)
    return out


def nerf_pass(p, pts, extra, z, d, bg, m):
    n, s = pts.shape[0], pts.shape[1]
    x_emb = embed(pts, m["nerf_xyz_freqs"], m["nerf_in_xyz"])
    e = None if extra is None else extra[:, None, :].expand(n, s, -1)
    raw = nerf(p, x_emb, e, m["nerf_skips"])
    act = torch.relu if m["act"] == "relu" else torch.nn.functional.softplus
    return composite(raw, z, torch.linalg.norm(d, dim=-1, keepdim=True), bg,
                     act)


def render_losses(params: dict, scene: dict, draws: dict, m: dict,
                  phase: str | None) -> dict:
    """Every loss term of one training step, as the configuration weighs
    them."""
    o, d, near, far, ind, target, bg = train_rays(scene, draws)
    near = torch.full_like(ind, near)
    far = torch.full_like(ind, far)
    z = stratified(near, far, m["n_samples"], draws["perturb"] * m["perturb"])
    if m["extra"] == "ind":
        extra = embed(ind, m["extra_freqs"], m["extra_dim"])
    elif m["extra"] == "dir":
        extra = embed(d, m["extra_freqs"], m["extra_dim"])
    else:
        extra = None
    chained = None
    if m["use_nof"] and m["chain_global"]:
        # the chained frame's index as the scene's table has it: with the
        # frame PE's top band at 2^15 a 1-ulp other rounding of the index
        # moves the fw NoF's first-layer gradient by 1e-3
        chained = torch.full_like(ind,
                                  scene["norm_idx"][draws["chained"]].item())

    def at(zz):
        return o[:, None, :] + d[:, None, :] * zz[..., None]

    xyz_c = at(z)
    w_c = warps(params, xyz_c, ind, chained, m) if m["use_nof"] else None
    rgb_c, wts_c, alpha_c = nerf_pass(
        params["coarse_NeRF"], w_c["cano"] if w_c else xyz_c, extra, z, d, bg,
        m)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_f = sample_pdf(z_mid, wts_c[:, 1:-1].detach(), draws["pdf"]).detach()
    z_all = torch.sort(torch.cat([z, z_f], -1), -1).values
    xyz_f = at(z_all)
    w_f = warps(params, xyz_f, ind, chained, m) if m["use_nof"] else None
    rgb_f, _, alpha_f = nerf_pass(
        params["fine_NeRF"], w_f["cano"] if w_f else xyz_f, extra, z_all, d,
        bg, m)
    img = ((rgb_c - target) ** 2).mean() + ((rgb_f - target) ** 2).mean()
    if not m["use_nof"]:
        return {"img_loss": img}
    losses = {"img_loss": img * m["w_img"]}
    for key, name in (("recon", "local"), ("chain_recon", "global")):
        if m[f"chain_{name}"]:
            losses[f"nof_{name}"] = (consensus(xyz_c, w_c[key], alpha_c)
                                     + consensus(xyz_f, w_f[key], alpha_f)) \
                * m[f"w_{name}"]
    if phase in ("msk", "full") and m["w_msk"] > 0:
        losses["alphas_mask"] = alpha_mask(params, scene, draws, m) * m["w_msk"]
    return losses


def nearest(verts: torch.Tensor, q: torch.Tensor):
    """(distance, index) of each query's nearest vertex, in float64."""
    d2 = ((q.double()[:, None, :] - verts.double()[None]) ** 2).sum(-1)
    best, idx = d2.min(1)
    return best.sqrt().float(), idx


def alpha_mask(params, scene, draws, m):
    """The ``msk`` term: the BCE toward 0 of the canonical alpha of the
    bw-warped correspondence points that lie farther than 0.2 from the
    body."""
    f = draws["frame"]
    verts = scene["verts"][f]
    q = torch.cat([draws["cube"], verts[draws["pick"]] + draws["noise"] * 0.2])
    dist, _ = nearest(verts, q)
    outside = dist >= 0.2
    ind = scene["norm_idx"][f].reshape(1, 1)
    cano = nof(params["bw_NoF"], q[None], ind, m)[0]
    x_emb = embed(cano, m["nerf_xyz_freqs"], m["nerf_in_xyz"])

    def bce0(net, delta):
        sig = nerf(params[net], x_emb, None, m["nerf_skips"],
                   sigma_only=True)[:, 0]
        a = 1.0 - torch.exp(-delta * torch.nn.functional.softplus(sig))
        e = -torch.log(1.0 - a.clamp(1e-7, 1.0 - 1e-7))
        return masked_mean(e, outside)

    s, i = m["n_samples"], m["n_importance"]
    return 0.5 * (bce0("coarse_NeRF", 1.0 / s) + bce0("fine_NeRF", 1.0 / (s + i)))


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) at a fixed learning rate."""

    def __init__(self, params: list, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list):
        self.t += 1
        bc1, bc2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt() + 1e-8))


class RAdam:
    """RAdam (b1 0.9, b2 0.999, eps 1e-8 on sqrt(v)): the rectified step
    where the variance estimate's length is at least 5, else the
    bias-corrected momentum."""

    def __init__(self, params: list, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list):
        self.t += 1
        b1, b2, t = 0.9, 0.999, self.t
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho = rho_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)
        bc1 = 1.0 - b1 ** t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            if rho >= 5.0:
                r = math.sqrt((1.0 - b2 ** t) * (rho - 4.0) * (rho - 2.0)
                              * rho_inf / ((rho_inf - 4.0) * (rho_inf - 2.0)
                                           * rho)) / bc1
                p.sub_(self.lr * r * m / (v.sqrt() + 1e-8))
            else:
                p.sub_(self.lr * m / bc1)


OPTIMIZERS = {"adam": Adam, "radam": RAdam}


def optimizer_spec(cfg: dict, phase: str | None) -> dict:
    """The one optimizer that steps in the traffic's phase: ``moco`` of a
    stage-3 config (its ``nof`` optimizer is gone past the c2f start, as
    ``phase`` ``msk`` / ``none`` say), else the config's own. Its learning
    rate is the schedule's first (the step count is below every
    milestone)."""
    opt = cfg["optimizer"]
    spec = opt["moco"] if "moco" in opt else opt
    if spec.get("weight_decay"):
        raise ValueError("the reference has no weight decay")
    milestones = (cfg.get("scheduler") or {}).get("decay_step", [])
    if any(int(s) <= 3 for s in milestones):
        raise ValueError("a learning-rate milestone within the first steps")
    return spec


def leaves(tree, prefix: str = "") -> dict:
    """{'coarse_NeRF/trunk/0/w': tensor, ...} in the tree's order."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, torch.Tensor):
            out[path] = v
        else:
            out.update(leaves(v, path))
    return out


def run_steps(cfg: dict, params: dict, scene: dict, draws_list: list,
              phase: str | None, dtype=torch.float32) -> dict:
    """The reference's steps from ``params`` (a tree of tensors, copied here
    in ``dtype``) on each step's draws. Returns the total loss and the loss
    terms of each step, the first step's gradient of each leaf and the
    parameters after the last step. ``dtype`` float64 gives a witness of
    the float32 reference's own rounding."""
    m = model_dims(cfg)
    spec = optimizer_spec(cfg, phase)
    tree = _copy(params, dtype)
    if dtype != torch.float32:
        scene, draws_list = _cast(scene, dtype), _cast(draws_list, dtype)
    named = leaves(tree)
    for t in named.values():
        t.requires_grad_(True)
    opt = OPTIMIZERS[spec["type"]](list(named.values()), float(spec["lr"]))
    losses, step_terms, first_grad = [], [], None
    for draws in draws_list:
        terms = render_losses(tree, scene, draws, m, phase)
        total = sum(terms.values())
        grads = torch.autograd.grad(total, list(named.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(named.values(), grads)]
        if first_grad is None:
            first_grad = {k: g.detach().clone()
                          for k, g in zip(named, grads)}
        opt.step(grads)
        losses.append(float(total.detach()))
        step_terms.append({k: float(v.detach()) for k, v in terms.items()})
    return {"losses": losses, "terms": step_terms, "first_grad": first_grad,
            "params": {k: t.detach().clone() for k, t in named.items()}}


def _copy(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _copy(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v, dtype) for v in tree]
    return tree.detach().clone().to(dtype)


def _cast(tree, dtype):
    """Floating tensors of a tree of dicts and lists in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def param_tree(cfg: dict, device) -> dict:
    """Zero parameters of the configuration's networks, in the order the
    benchmark fills them from the seed: the coarse and fine NeRF (trunk,
    sigma, final, extra, rgb), then for a stage-3 model the bw and fw NoF
    (layers, head); each layer ``{'w': (in, out), 'b': (out,)}``."""
    mc = cfg["model"]

    def lin(i, o):
        return {"w": torch.zeros((i, o), device=device),
                "b": torch.zeros((o,), device=device)}

    def nerf_tree(nc):
        d, w, x = nc["D"], nc["W"], nc["in_channels_xyz"]
        e = nc.get("extra_feat_dim", 0) if nc.get(
            "extra_feat_type", "none") != "none" else 0
        trunk = [lin((x if i == 0 else w) + (x if i in nc["skips"] else 0),
                     w) for i in range(d)]
        return {"trunk": trunk, "sigma": lin(w, 1), "final": lin(w, w),
                "extra": lin(w + e, w // 2), "rgb": lin(w // 2, 3)}

    def nof_tree(nc):
        d, w = nc["D"], nc["W"]
        x = nc["in_channels_xyz"] + nc["extra_feat_dim"]
        return {"layers": [lin((x if i == 0 else w)
                               + (x if i in nc["skips"] else 0), w)
                           for i in range(d)],
                "head": lin(w, 9 if nc.get("use_quat", True) else 3)}

    tree = {"coarse_NeRF": nerf_tree(mc["coarse_NeRF"]),
            "fine_NeRF": nerf_tree(mc["fine_NeRF"])}
    if mc["type"] == "moco_flow":
        lc = cfg.get("loss") or {}
        tree["bw_NoF"] = nof_tree(mc["bw_NoF"])
        if lc.get("chain_local") or lc.get("chain_global"):
            tree["fw_NoF"] = nof_tree(mc["fw_NoF"])
    return tree
