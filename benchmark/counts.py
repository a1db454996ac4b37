"""Operations and bytes of the training step and of kernels #1-#6, from the
configuration's widths and the step's shapes.

Operations are the matrix products' multiply-adds times two: the
positional encoding, activations, the quaternion head's elementwise work
and compositing are not counted. An input that is the same for every
sample of a ray (the NeRF's extra feature, the NoF's frame embedding) is
counted once a ray. A backward counts the input-gradient and the
weight-gradient products, which is exactly twice its forward; recompute is
not counted, whatever a kernel recomputes. Bytes count each input and each
output of a launch once, in float32: positions, cotangents, per-ray
partials, weights and weight gradients.

``PEAK_FLOPS`` is the H100 SXM's dense TF32 rate: the configurations are
float32, and no float32-faithful product runs above it (a split-TF32
product takes three passes). ``PEAK_BYTES`` is its HBM3 bandwidth.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32 = 4


@dataclasses.dataclass(frozen=True)
class Net:
    """Multiply-adds of one MLP evaluation: per sample, and per ray for the
    inputs that a ray's samples share; its parameter count."""
    sample_macs: int
    ray_macs: int
    params: int


def _emb_width(in_ch: int, n_freqs: int) -> int:
    return in_ch * (2 * n_freqs + 1)


def nerf_net(cfg: dict, sigma_only: bool = False) -> Net:
    """The NeRF of ``cfg['model']``: the trunk on the embedded position (its
    true width, without the zero padding to ``in_channels_xyz``), the sigma
    head and, unless ``sigma_only``, ``final``, the extra layer (its
    extra-feature rows once a ray) and the rgb head."""
    mc = cfg["model"]
    nc = mc["coarse_NeRF"]
    d, w = nc["D"], nc["W"]
    x = _emb_width(3, (mc.get("nerf_embedding_xyz") or {}).get("N_freqs", 0))
    macs = 0
    for i in range(d):
        macs += (x if i == 0 else w) * w + (x * w if i in nc["skips"] else 0)
    macs += w * 1
    params = sum(((nc["in_channels_xyz"] if i == 0 else w)
                  + (nc["in_channels_xyz"] if i in nc["skips"] else 0) + 1) * w
                 for i in range(d)) + (w + 1)
    ray = 0
    if not sigma_only:
        e = nc.get("extra_feat_dim", 0) if nc.get(
            "extra_feat_type", "none") != "none" else 0
        macs += w * w + w * (w // 2) + (w // 2) * 3
        ray = e * (w // 2)
        params += (w + 1) * w + (w + e + 1) * (w // 2) + (w // 2 + 1) * 3
    return Net(macs, ray, params)


def nof_net(cfg: dict) -> Net:
    """One NoF of ``cfg['model']``: its layers on the embedded position
    (per sample) and the embedded frame index (per ray), and the 9-wide
    quaternion head."""
    mc = cfg["model"]
    nc = mc["bw_NoF"]
    d, w = nc["D"], nc["W"]
    x = nc["in_channels_xyz"]
    e = nc["extra_feat_dim"]
    macs = ray = 0
    for i in range(d):
        if i == 0:
            macs, ray = macs + x * w, ray + e * w
        elif i in nc["skips"]:
            macs, ray = macs + (w + x) * w, ray + e * w
        else:
            macs += w * w
    head = 9 if nc.get("use_quat", True) else 3
    macs += w * head
    params = sum(((x + e if i == 0 else w) + (x + e if i in nc["skips"] else 0)
                  + 1) * w for i in range(d)) + (w + 1) * head
    return Net(macs, ray, params)


def chain_evals(cfg: dict) -> tuple[int, int]:
    """(NoF evaluations a sample, per-ray partial sets a ray) of the warp
    chain: bw; fw (local); fw, bw at the chained frame, fw (global)."""
    lc = cfg.get("loss") or {}
    evals, sets = 1, 1
    if lc.get("chain_local"):
        evals, sets = evals + 1, 2
    if lc.get("chain_global"):
        evals, sets = evals + 3, 4
    return evals, sets


@dataclasses.dataclass(frozen=True)
class Launch:
    kernel: str      # '#1' ... '#6'
    flops: float
    bytes: float

    @property
    def bound_s(self) -> float:
        """The least time the card could take: operations over the peak or
        bytes over the bandwidth, whichever is longer."""
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)


def nerf_launches(cfg: dict, n: int, s: int) -> list[Launch]:
    """#1 and #2 on ``n`` rays of ``s`` samples."""
    net = nerf_net(cfg)
    w = cfg["model"]["coarse_NeRF"]["W"]
    flops = 2.0 * n * s * net.sample_macs
    part = n * (w // 2) * F32
    wb = net.params * F32
    fwd_in, fwd_out = 3 * n * s * F32 + part + wb, 4 * n * s * F32
    bwd_in = 3 * n * s * F32 + 4 * n * s * F32 + part + wb
    bwd_out = 3 * n * s * F32 + part + wb
    return [Launch("#1", flops, fwd_in + fwd_out),
            Launch("#2", 2 * flops, bwd_in + bwd_out)]


def chain_launches(cfg: dict, n: int, s: int) -> list[Launch]:
    """#5 and #6 on ``n`` rays of ``s`` samples."""
    net = nof_net(cfg)
    evals, sets = chain_evals(cfg)
    w = cfg["model"]["bw_NoF"]["W"]
    outs = 1 + bool((cfg.get("loss") or {}).get("chain_local")) + bool(
        (cfg.get("loss") or {}).get("chain_global"))
    flops = 2.0 * n * s * evals * net.sample_macs
    parts = sets * 2 * n * w * F32          # layer 0 and the skip layer
    wb = 2 * net.params * F32
    xyz = 3 * n * s * F32
    return [Launch("#5", flops, xyz + parts + wb + outs * xyz),
            Launch("#6", 2 * flops, xyz + outs * xyz + parts + wb
                   + xyz + parts + wb)]


def nof_launches(cfg: dict, m: int) -> list[Launch]:
    """#3 and #4 on ``m`` points of one frame."""
    net = nof_net(cfg)
    w = cfg["model"]["bw_NoF"]["W"]
    flops = 2.0 * m * net.sample_macs
    xyz, parts, wb = 3 * m * F32, 2 * w * F32, net.params * F32
    return [Launch("#3", flops, xyz + parts + wb + xyz),
            Launch("#4", 2 * flops, xyz + xyz + parts + wb + xyz + parts
                   + wb)]


def step_launches(cfg: dict, phase: str | None) -> list[Launch]:
    """The launches of #1-#6 in one training step of the whole-ray route:
    the coarse and fine NeRF (#1 / #2 on S and S + I samples); with the NoF,
    the warp chain of the coarse samples and of the importance samples
    (#5 / #6 on S and I); in the ``msk`` / ``full`` phases the bw NoF on
    the 2 x N_sampled correspondence points (#3 / #4; a ``full`` step's fw
    NoF adds a second pair)."""
    mc = cfg["model"]
    n, s, i = mc["N_rand"], mc["N_samples"], mc["N_importance"]
    out = nerf_launches(cfg, n, s) + nerf_launches(cfg, n, s + i)
    if mc["type"] == "moco_flow":
        out += chain_launches(cfg, n, s) + chain_launches(cfg, n, i)
        if phase in ("msk", "full"):
            pts = 2 * int(mc["N_sampled"])
            out += nof_launches(cfg, pts) * (2 if phase == "full" else 1)
    return out


def step_model_flops(cfg: dict, phase: str | None) -> float:
    """Model operations of one training step: forward plus twice the
    forward, with every network evaluation of the step's losses, the
    per-ray parts once a ray."""
    mc = cfg["model"]
    n, s, i = mc["N_rand"], mc["N_samples"], mc["N_importance"]
    nerf = nerf_net(cfg)
    fwd = n * (s + (s + i)) * nerf.sample_macs + 2 * n * nerf.ray_macs
    if mc["type"] == "moco_flow":
        nof = nof_net(cfg)
        evals, sets = chain_evals(cfg)
        fwd += n * (s + i) * evals * nof.sample_macs + 2 * n * sets * \
            nof.ray_macs
        if phase in ("msk", "full"):
            pts = 2 * int(mc["N_sampled"])
            nets = 2 if phase == "full" else 1
            fwd += nets * (pts * nof.sample_macs + nof.ray_macs)
            sig = nerf_net(cfg, sigma_only=True)
            fwd += 2 * pts * sig.sample_macs
    return 3 * 2.0 * fwd
