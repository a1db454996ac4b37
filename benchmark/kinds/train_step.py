"""Training steps of a stage-1 or stage-3 trainer: the kind ``train_step``.

Its traffic mix (``traffic/<mix>.json``) gives ``clock_step`` (the
trainer's clock when the run starts), ``phase`` (the stage-3 phase that
clock has to be in, or null), ``resume_state`` (the trainer state that a
resumed run has, as ``load_extra_state`` takes it) and ``check_steps`` (the
steps that the reference follows).

Set-up makes the scene and the weights on the device from the seed
(``scene.py``), builds the program's trainer through its own entry points
(``get_trainer``, ``build_model``, ``configure_optimizers``,
``set_train_data``) and drives it through the first ``check_steps`` steps
on the window's own call and feed: they warm every shape of the step, and
the reference follows them. The window goes on with the same trainer. A
step is that step's draws, made from (seed, step), and
``trainer.train_step(draws=...)``.

A step's work is ``counts.step_model_flops`` and ``counts.step_launches``,
run by kernels #1-#6 (``kernels.STEP_KERNELS``). The comparison is
``train_check``'s, the faults are ``train_faults``'s, and the control is
the reference in TF32.
"""

from __future__ import annotations

import gc
import shutil
import tempfile

import numpy as np
import torch

from benchmark import counts, kernels, reference, scene, train_check
from benchmark.reference.model import leaves, param_tree
from benchmark.train_faults import KINDS as FAULTS, plant

def draw_step(cfg: dict, traffic: dict, sc: dict, seed: int, step: int,
              device) -> dict:
    """Every random input of one step, from (``seed``, ``step``): the same
    sizes whatever the seed. Returns the reference's dict; :func:`as_draws`
    makes the program's record of the same tensors."""
    mc = cfg["model"]
    n, s, i = mc["N_rand"], mc["N_samples"], mc["N_importance"]
    n_f = sc["c2w"].shape[0]
    rng = np.random.default_rng(scene.seed_of(seed, step, scene.HOST))
    frame = int(rng.integers(n_f))
    chained = int(rng.integers(n_f))
    gen = scene.device_gen(device, seed, step, scene.DRAWS)
    count = int(sc["valid_count_host"][frame])
    out = {"frame": frame, "chained": chained,
           "pixels": torch.randint(0, count, (n,), generator=gen,
                                   device=device),
           "background": torch.rand((1, 3), generator=gen, device=device),
           "perturb": torch.rand((n, s), generator=gen, device=device),
           "pdf": torch.rand((n, i), generator=gen, device=device)}
    if traffic.get("phase") in ("msk", "full"):
        ns, nv = int(mc["N_sampled"]), sc["verts"].shape[1]
        out["cube"] = torch.rand((ns, 3), generator=gen, device=device) * 3 - 1.5
        out["pick"] = torch.randint(0, nv, (ns,), generator=gen, device=device)
        out["noise"] = torch.randn((ns, 3), generator=gen, device=device)
    return out


def as_draws(d: dict, chain_global: bool):
    """The program's ``Draws`` record of the draws ``d``."""
    from moco_flow_tpu_torch.data.draws import Draws
    return Draws(frame=d["frame"], pixels=d["pixels"],
                 background=d["background"],
                 chained=d["chained"] if chain_global else None,
                 perturb=d["perturb"], pdf=d["pdf"], cube=d.get("cube"),
                 pick=d.get("pick"), noise=d.get("noise"))


def make_scene(cfg: dict, seed: int, device) -> dict:
    sc = scene.make_scene(cfg, seed, device)
    sc["valid_count_host"] = [int(c) for c in sc["valid_count"]]
    return sc


def build_trainer(cfg: dict, traffic: dict, sc: dict, seed: int, device,
                  save_dir: str):
    """The program's trainer of ``cfg``, built through its own entry
    points, its weights made from the seed, its data set, its clock and
    resumed state as the traffic says."""
    from moco_flow_tpu_torch.data.correspondence import CorrespondenceTable
    from moco_flow_tpu_torch.data.dataset import FrameTable
    from moco_flow_tpu_torch.train import get_trainer
    cfg = dict(cfg, save_dir=save_dir)
    tr = get_trainer(cfg, device=device, seed=seed % 2 ** 62)
    tr.build_model(cfg["model"])
    scene.make_weights(tr.params, cfg, seed, device)
    tr.configure_optimizers(cfg["optimizer"], cfg.get("scheduler"))
    table = FrameTable(c2w=sc["c2w"], near=sc["near"], far=sc["far"],
                       norm_idx=sc["norm_idx"], valid_idx=sc["valid_idx"],
                       valid_count=sc["valid_count"])
    corr = (CorrespondenceTable(sc["verts"], sc["src_to_cano"])
            if cfg["model"]["type"] == "moco_flow" else None)
    tr.set_train_data(table, sc["directions"], sc["images"], sc["bkgd"],
                      sc["rand_bkgd"], corr=corr)
    tr.clock.step = int(traffic.get("clock_step", 0))
    if traffic.get("resume_state"):
        tr.load_extra_state(traffic["resume_state"])
    want = traffic.get("phase")
    if want is not None and tr.phase(tr.clock.step)[0] != want:
        raise ValueError(f"step {tr.clock.step} is in phase "
                         f"{tr.phase(tr.clock.step)[0]!r}, not {want!r}")
    return tr


def _total(metrics: dict) -> torch.Tensor:
    return sum(v for k, v in metrics.items() if k != "train_psnr")


class Job:
    """One run's trainer, from set-up to the comparison."""

    def __init__(self, cell, seed: int, device, fault: str | None = None,
                 lap=lambda what: None):
        self.cfg, self.traffic, self.seed = cell.cfg, cell.traffic, seed
        self.device = torch.device(device)
        self.phase = self.traffic.get("phase")
        self.chain_global = bool((self.cfg.get("loss") or {}).get(
            "chain_global", False))
        self.scene = make_scene(self.cfg, seed, self.device)
        lap("scene")
        if self.device.type == "cuda":
            from moco_flow_tpu_torch.ops._build import load_library
            load_library()       # built by nvcc only in a checkout's first run
            lap("kernels")
        self.save_dir = tempfile.mkdtemp(prefix="bench_save_")
        self.trainer = build_trainer(self.cfg, self.traffic, self.scene,
                                     seed, self.device, self.save_dir)
        lap("trainer")
        if fault:
            plant(self.trainer, fault)
        self.n_check = int(self.traffic.get("check_steps", 3))
        named = leaves(self.trainer.params)
        self.start = {k: v.detach().clone() for k, v in named.items()}
        self.prog = {"losses": [], "terms": [], "start": self.start}
        for k in range(self.n_check):
            out = self.trainer.train_step(draws=self.draws(k))
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
        self.work = {"model_flops": counts.step_model_flops(self.cfg,
                                                            self.phase),
                     "launches": counts.step_launches(self.cfg, self.phase),
                     "roofline_kernel": kernels.is_step_kernel}
        self.diagnose: dict = {}

    def draws(self, step: int, reference: bool = False):
        d = draw_step(self.cfg, self.traffic, self.scene, self.seed, step,
                      self.device)
        return d if reference else as_draws(d, self.chain_global)

    def step(self, i: int) -> torch.Tensor:
        """The window's ``i``-th step: the steps after the checked ones."""
        with torch.profiler.record_function("bench.draws"):
            draws = self.draws(self.n_check + i)
        out = self.trainer.train_step(draws=draws)
        self.trainer.clock.tick()
        return _total(out).detach()

    def finish(self) -> None:
        del self.trainer
        shutil.rmtree(self.save_dir, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> dict:
        tree = param_tree(self.cfg, self.device)
        for k, t in leaves(tree).items():
            t.copy_(self.start[k])
        ref = reference.run_steps(
            self.cfg, tree, self.scene,
            [self.draws(k, reference=True) for k in range(self.n_check)],
            self.phase)
        ref["start"] = self.start
        self.diagnose.update(train_check.details(self.prog, ref))
        return train_check.readings(self.prog, ref)


def setup(cell, seed: int, device, fault: str | None = None,
          lap=lambda what: None) -> Job:
    return Job(cell, seed, device, fault, lap)


def _reference_runs(cell, seed: int, device, dtypes) -> list:
    """The reference from the cell's weights over its first steps' draws,
    once in each of ``dtypes`` (``'tf32'`` is float32 with TF32 on)."""
    device = torch.device(device)
    sc = make_scene(cell.cfg, seed, device)
    tree = param_tree(cell.cfg, device)
    scene.make_weights(tree, cell.cfg, seed, device)
    start = {k: v.detach().clone() for k, v in leaves(tree).items()}
    phase = cell.traffic.get("phase")
    draws = [draw_step(cell.cfg, cell.traffic, sc, seed, k, device)
             for k in range(int(cell.traffic.get("check_steps", 3)))]
    out = []
    for dt in dtypes:
        tf32 = dt == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            run = reference.run_steps(
                cell.cfg, tree, sc, draws, phase,
                dtype=torch.float32 if tf32 else dt)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        run["start"] = start
        out.append(run)
    return out


def control(cell, seed: int, device) -> dict:
    """The reference in TF32 in the program's place, against the reference
    in float32, on the cell's scene, weights and first steps' draws."""
    low, ref = _reference_runs(cell, seed, device, ("tf32", torch.float32))
    return train_check.readings(low, ref)


def witness(cell, seed: int, device) -> dict:
    """The float32 reference in the program's place against the reference
    in float64: the reference's own rounding, with its consensus terms'."""
    f32, f64 = _reference_runs(cell, seed, device,
                               (torch.float32, torch.float64))
    out = train_check.readings(f32, f64)
    out["consensus_gap"] = train_check.details(f32, f64)["consensus_gap"]
    return out
