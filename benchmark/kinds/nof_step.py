"""Training steps of the stage-2 trainer (the NoF pretraining): the kind
``nof_step``.

Its traffic mix (``traffic/<mix>.json``) gives ``clock_step`` (the
trainer's clock when the run starts) and ``check_steps`` (the steps that
the reference follows).

Set-up builds what stage 2 reads on the device from the seed: the posed
body's vertices, their src -> canonical chains and the frames' normalized
indices (``scene.make_scene``'s body; no images). It builds the program's
trainer through its own entry points (``get_trainer`` with ``model.type``
``nof``, ``build_model``, ``configure_optimizers``, ``set_points``), fills
its weights from the seed (``scene.make_weights``) and drives it through
the first ``check_steps`` steps on the window's own call: they warm every
shape of the step, and the reference (``reference/nof_stage.py``) follows
them. The window goes on with the same trainer. A step is
``trainer.train_step(draws=...)`` on draws that this module makes from
(seed, step) (:func:`draw_step`, inside ``bench.draws``), as
``train_step.py`` makes a stage-3 step's: the frame on the host, the
points on the device. The trainer's own ``draw`` makes them on the host
with torch's CPU generator and copies them over; that serial host work
would set the pace of a step whose device work takes less time, so the
cell would time the host's random numbers rather than the step.

A step's work is both NoFs' forward plus twice the forward on the
``2 * N_sampled`` points, run by kernels #3/#4 (``counts.nof_launches``
for each NoF, ``kernels.is_step_kernel``), and the KNN's blocks
(``ops/knn.py::chunk_rows``). The comparison is ``train_check``'s; the
faults are this module's (``FAULTS``); the control is the reference in
TF32, the witness the float32 reference against the float64 one.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from benchmark import counts, kernels, scene, train_check
from benchmark.reference import nof_stage
from benchmark.reference.model import leaves

# Faults planted under the timed path, each wrapping the trainer's
# ``train_step``: ``stale`` puts every parameter back after the step;
# ``stale_part`` puts the fw NoF back (an optimizer that dropped it);
# ``half`` trains on the first half of the cube points and of the surface
# points; ``alter`` reports the step's ``nof_bw`` 1% high.
FAULTS = ("stale", "stale_part", "half", "alter")


def plant(trainer, kind: str) -> None:
    """Break ``trainer.train_step`` as ``kind`` says."""
    step = trainer.train_step

    def broken(draws=None):
        if kind == "half":
            n = draws.cube.shape[0] // 2
            return step(draws=dataclasses.replace(
                draws, cube=draws.cube[:n], pick=draws.pick[:n],
                noise=draws.noise[:n]))
        if kind in ("stale", "stale_part"):
            named = {k: t for k, t in leaves(trainer.params).items()
                     if kind == "stale" or k.startswith("fw_NoF/")}
            before = {k: t.detach().clone() for k, t in named.items()}
            out = step(draws=draws)
            with torch.no_grad():
                for k, t in named.items():
                    t.copy_(before[k])
            return out
        if kind == "alter":
            out = step(draws=draws)
            out["nof_bw"] = out["nof_bw"] * 1.01
            return out
        raise ValueError(f"unknown fault {kind!r}")

    trainer.train_step = broken


def make_body(cfg: dict, seed: int, device) -> dict:
    """``scene.make_scene``'s posed body from ``seed`` on ``device``, and
    nothing of its cameras or frames: ``verts`` (F, V, 3), ``src_to_cano``
    (F, V, 4, 4), ``norm_idx`` (F,) and each vertex's ``part`` (V,)."""
    sc = cfg["scene"]
    n_f, n_v = int(cfg["num_frames"]), int(sc["num_verts"])
    gen = scene.device_gen(device, seed, scene.SCENE)
    ext = torch.tensor(sc["body_extent"], device=device)
    rest = torch.randn((n_v, 3), generator=gen, device=device)
    rest = rest / rest.norm(dim=-1, keepdim=True) * ext
    band = ((rest[:, 1] + ext[1]) / (2 * ext[1]) * 12).long().clamp(0, 11)
    part = band * 2 + (rest[:, 0] > 0).long()                     # (V,)
    centres = torch.zeros((24, 3), device=device).index_add_(
        0, part, rest) / torch.bincount(part, minlength=24).clamp_min(
            1)[:, None].float()
    rot = scene._rotations(torch.randn((n_f, 24, 3), generator=gen,
                                       device=device)
                           * float(sc["pose_scale"]))            # (F, 24, 3, 3)
    eye4 = torch.eye(4, device=device)
    posed = eye4.repeat(n_f, 24, 1, 1)                            # rest -> frame
    posed[..., :3, :3] = rot
    posed[..., :3, 3] = centres - (rot @ centres[..., None])[..., 0]
    verts = (rot[:, part] @ rest[..., None])[..., 0] + posed[:, part, :3, 3]
    inv = eye4.repeat(n_f, 24, 1, 1)                              # frame -> rest
    inv[..., :3, :3] = rot.transpose(-1, -2)
    inv[..., :3, 3] = -(inv[..., :3, :3] @ posed[..., :3, 3, None])[..., 0]
    src_to_cano = (posed[0][None] @ inv)[:, part]                 # (F, V, 4, 4)
    return {"verts": verts, "src_to_cano": src_to_cano,
            "norm_idx": torch.arange(n_f, device=device) * 2.0 / n_f - 1.0,
            "part": part}


def build_trainer(cfg: dict, traffic: dict, body: dict, seed: int, device):
    """The program's stage-2 trainer of ``cfg``, built through its own
    entry points as ``train/__main__.py::train`` builds it, its weights
    made from the seed, its points set and its clock as the traffic
    says."""
    from moco_flow_tpu_torch.data.correspondence import CorrespondenceTable
    from moco_flow_tpu_torch.train import get_trainer
    tr = get_trainer(cfg, device=device, seed=seed % 2 ** 62)
    tr.build_model(cfg["model"])
    scene.make_weights(tr.params, cfg, seed, device)
    tr.set_points(CorrespondenceTable(body["verts"], body["src_to_cano"]),
                  body["norm_idx"])
    tr.configure_optimizers(cfg["optimizer"], cfg.get("scheduler"))
    tr.clock.step = int(traffic.get("clock_step", 0))
    return tr


def draw_step(cfg: dict, seed: int, step: int, num_frames: int,
              num_verts: int, device) -> dict:
    """Every random input of one stage-2 step, from (``seed``, ``step``):
    the frame uniform over ``num_frames`` (on the host), then on the device
    ``N_sampled`` cube points uniform in +-1.5, as many vertex picks over
    ``num_verts`` and their standard normal surface noise (the trainer
    scales it by the thickness, 0.1). Returns the reference's dict;
    :func:`as_point_draws` makes the program's record of the same
    tensors."""
    ns = int(cfg["model"]["N_sampled"])
    rng = np.random.default_rng(scene.seed_of(seed, step, scene.HOST))
    gen = scene.device_gen(device, seed, step, scene.DRAWS)
    return {"frame": int(rng.integers(num_frames)),
            "cube": torch.rand((ns, 3), generator=gen, device=device) * 3
            - 1.5,
            "pick": torch.randint(0, num_verts, (ns,), generator=gen,
                                  device=device),
            "noise": torch.randn((ns, 3), generator=gen, device=device)}


def as_point_draws(d: dict):
    """The program's ``PointDraws`` record of the draws ``d``."""
    from moco_flow_tpu_torch.data.draws import PointDraws
    return PointDraws(d["frame"], d["cube"], d["pick"], d["noise"])


def body_draws(cfg: dict, body: dict, seed: int, step: int, device) -> dict:
    """:func:`draw_step` over ``body``'s frames and vertices."""
    n_f, n_v = body["verts"].shape[:2]
    return draw_step(cfg, seed, step, n_f, n_v, device)


def knn_work(num_verts: int, queries: int) -> dict:
    """The KNN's launches a step, the query rows of each and the bytes of
    the (rows, V) float32 block each writes, as ``nearest_neighbor``
    splits the queries (``chunk_rows``, ``MIN_ROWS``)."""
    from moco_flow_tpu_torch.ops.knn import MIN_ROWS, chunk_rows
    launches = max(1, -(-queries // chunk_rows(num_verts)))
    rows = max(MIN_ROWS, -(-queries // launches))
    return {"launches": launches, "rows": rows,
            "block_bytes": 4 * rows * num_verts}


def step_work(cfg: dict, num_verts: int) -> dict:
    """What one step counts: both NoFs on the ``2 * N_sampled`` points,
    forward plus twice the forward (the frame's inputs once), their #3/#4
    launches, and the KNN."""
    pts = 2 * int(cfg["model"]["N_sampled"])
    net = counts.nof_net(cfg)
    return {"model_flops": 2 * 3 * 2.0 * (pts * net.sample_macs
                                          + net.ray_macs),
            "launches": counts.nof_launches(cfg, pts) * 2,
            "roofline_kernel": kernels.is_step_kernel,
            "knn": knn_work(num_verts, pts)}


def _total(metrics: dict) -> torch.Tensor:
    return sum(metrics.values())


class Job:
    """One run's trainer, from set-up to the comparison."""

    def __init__(self, cell, seed: int, device, fault: str | None = None,
                 lap=lambda what: None):
        self.cfg, self.traffic, self.seed = cell.cfg, cell.traffic, seed
        self.device = torch.device(device)
        self.body = make_body(self.cfg, seed, self.device)
        lap("body")
        if self.device.type == "cuda":
            from moco_flow_tpu_torch.ops._build import load_library
            load_library()       # built by nvcc only in a checkout's first run
            lap("kernels")
        self.trainer = build_trainer(self.cfg, self.traffic, self.body, seed,
                                     self.device)
        lap("trainer")
        if fault:
            plant(self.trainer, fault)
        self.n_check = int(self.traffic.get("check_steps", 3))
        named = leaves(self.trainer.params)
        self.start = {k: v.detach().clone() for k, v in named.items()}
        self.prog = {"losses": [], "terms": [], "start": self.start}
        self.checked = []
        for k in range(self.n_check):
            draws = self.draws(k)
            self.checked.append(draws)
            out = self.trainer.train_step(draws=as_point_draws(draws))
            self.prog["losses"].append(float(_total(out)))
            self.prog["terms"].append({n: float(v) for n, v in out.items()})
            if k == 0:
                self.prog["first_grad"] = train_check.first_grads(
                    self.trainer.opt, list(named))
                lap("first step")
            self.trainer.clock.tick()
        self.prog["params"] = {k: v.detach().clone()
                               for k, v in leaves(self.trainer.params).items()}
        lap("later steps")
        self.work = step_work(self.cfg, self.body["verts"].shape[1])
        self.diagnose: dict = {}

    def draws(self, step: int) -> dict:
        return body_draws(self.cfg, self.body, self.seed, step, self.device)

    def step(self, i: int) -> torch.Tensor:
        """The window's ``i``-th step: the steps after the checked ones."""
        with torch.profiler.record_function("bench.draws"):
            draws = as_point_draws(self.draws(self.n_check + i))
        out = self.trainer.train_step(draws=draws)
        self.trainer.clock.tick()
        return _total(out).detach()

    def finish(self) -> None:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> dict:
        tree = nof_stage.param_tree(self.cfg, self.device)
        for k, t in leaves(tree).items():
            t.copy_(self.start[k])
        ref = nof_stage.run_steps(self.cfg, tree, self.body, self.checked)
        ref["start"] = self.start
        self.diagnose.update(train_check.details(self.prog, ref))
        self.diagnose.update(knn_flips(self.body, self.checked))
        return train_check.readings(self.prog, ref)


def knn_flips(body: dict, draws_list: list) -> dict:
    """For each step, the queries whose nearest vertex in the program's
    float32 KNN is not the float64 one, and how many of those lie in
    another part of the body (another chain, so another canonical
    point)."""
    from moco_flow_tpu_torch.ops.knn import nearest_neighbor
    flips, across = [], []
    for d in draws_list:
        q, _, want = nof_stage.correspondences(body, d)
        _, got = nearest_neighbor(body["verts"][d["frame"]], q)
        off = got != want
        flips.append(int(off.sum()))
        across.append(int((body["part"][got[off]]
                           != body["part"][want[off]]).sum()))
    return {"knn_flips": flips, "knn_flips_across_parts": across}


def setup(cell, seed: int, device, fault: str | None = None,
          lap=lambda what: None) -> Job:
    return Job(cell, seed, device, fault, lap)


def _reference_runs(cell, seed: int, device, dtypes) -> list:
    """The reference from the cell's weights over its first steps' draws,
    once in each of ``dtypes`` (``'tf32'`` is float32 with TF32 on). The
    weights are the program's trainer's, built as set-up builds it and
    never stepped; the draws are set-up's (:func:`draw_step`)."""
    device = torch.device(device)
    body = make_body(cell.cfg, seed, device)
    tr = build_trainer(cell.cfg, cell.traffic, body, seed, device)
    start = {k: v.detach().clone() for k, v in leaves(tr.params).items()}
    draws = [body_draws(cell.cfg, body, seed, k, device)
             for k in range(int(cell.traffic.get("check_steps", 3)))]
    del tr
    tree = nof_stage.param_tree(cell.cfg, device)
    for k, t in leaves(tree).items():
        t.copy_(start[k])
    out = []
    for dt in dtypes:
        tf32 = dt == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            run = nof_stage.run_steps(cell.cfg, tree, body, draws,
                                      dtype=torch.float32 if tf32 else dt)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        run["start"] = start
        out.append(run)
    return out


def control(cell, seed: int, device) -> dict:
    """The reference in TF32 in the program's place, against the reference
    in float32, on the cell's body, weights and first steps' draws."""
    low, ref = _reference_runs(cell, seed, device, ("tf32", torch.float32))
    return train_check.readings(low, ref)


def witness(cell, seed: int, device) -> dict:
    """The float32 reference in the program's place against the reference
    in float64: the reference's own rounding."""
    f32, f64 = _reference_runs(cell, seed, device,
                               (torch.float32, torch.float64))
    return train_check.readings(f32, f64)
