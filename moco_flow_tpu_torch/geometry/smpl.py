"""SMPL body model: shape and pose blendshapes, forward kinematics over the
24-joint tree and linear blend skinning.

Port of ``moco_flow_tpu/geometry/smpl.py``. The dataset needs posed vertices
for each frame's AABB, and so for near/far, and the per-vertex rest -> posed
transforms for the NoF supervision's correspondence table.
``synthetic_smpl_data`` draws the same arrays as the JAX package from the
same seed (numpy).
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

NUM_JOINTS = 24


@dataclasses.dataclass
class SMPLData:
    """SMPL model constants as host numpy arrays."""
    v_template: np.ndarray   # (V, 3)
    shapedirs: np.ndarray    # (V, 3, 10)
    posedirs: np.ndarray     # (V, 3, 207)
    j_regressor: np.ndarray  # (24, V)
    lbs_weights: np.ndarray  # (V, 24)
    parents: np.ndarray      # (23,) parent of joints 1..23
    faces: np.ndarray        # (F, 3)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]


def load_smpl_data(gender: str = "neutral", model_dir: str | None = None) -> SMPLData:
    """Load ``basicmodel_<gender>_lbs_10_207_0_v1.1.0.pkl`` from ``model_dir``,
    ``$SMPL_MODEL_DIR`` or ``./data/smpl``. The pickle is a trusted,
    user-downloaded model file."""
    candidates = []
    if model_dir:
        candidates.append(model_dir)
    if os.environ.get("SMPL_MODEL_DIR"):
        candidates.append(os.environ["SMPL_MODEL_DIR"])
    candidates.append(os.path.join(os.getcwd(), "data", "smpl"))
    name = f"basicmodel_{gender}_lbs_10_207_0_v1.1.0.pkl"
    for d in candidates:
        path = os.path.join(d, name)
        if os.path.exists(path):
            break
    else:
        raise FileNotFoundError(
            f"SMPL model {name} not found in {candidates}; set SMPL_MODEL_DIR "
            "or pass model_dir (download from the SMPL website).")
    with open(path, "rb") as f:
        m = pickle.load(f, encoding="iso-8859-1")
    jr = m["J_regressor"]
    jr = np.asarray(jr.todense()) if hasattr(jr, "todense") else np.asarray(jr)
    kin = np.asarray(m["kintree_table"]).astype(np.int64)
    id_to_col = {int(kin[1, i]): i for i in range(kin.shape[1])}
    parents = np.array([id_to_col[int(kin[0, i])]
                        for i in range(1, kin.shape[1])])
    return SMPLData(
        v_template=np.asarray(m["v_template"], np.float32),
        shapedirs=np.asarray(m["shapedirs"], np.float32)[:, :, :10],
        posedirs=np.asarray(m["posedirs"], np.float32),
        j_regressor=np.asarray(jr, np.float32),
        lbs_weights=np.asarray(m["weights"], np.float32),
        parents=parents,
        faces=np.asarray(m["f"]).astype(np.int64),
    )


def save_smpl_data(smpl: SMPLData, model_dir: str,
                   gender: str = "neutral") -> str:
    """Write ``smpl`` as the SMPL pickle that :func:`load_smpl_data` reads
    (the basicmodel schema: float64 arrays, a scipy-sparse
    ``J_regressor``, ``kintree_table`` with the root's parent 2^32 - 1);
    returns its path."""
    import scipy.sparse
    kintree = np.zeros((2, NUM_JOINTS), np.uint32)
    kintree[1] = np.arange(NUM_JOINTS)
    kintree[0, 0] = 0xFFFFFFFF
    kintree[0, 1:] = smpl.parents
    m = {"v_template": smpl.v_template.astype(np.float64),
         "shapedirs": smpl.shapedirs.astype(np.float64),
         "posedirs": smpl.posedirs.astype(np.float64),
         "J_regressor": scipy.sparse.csr_matrix(smpl.j_regressor),
         "weights": smpl.lbs_weights.astype(np.float64),
         "kintree_table": kintree,
         "f": smpl.faces.astype(np.uint32)}
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir,
                        f"basicmodel_{gender}_lbs_10_207_0_v1.1.0.pkl")
    with open(path, "wb") as f:
        pickle.dump(m, f)
    return path


def synthetic_smpl_data(num_vertices: int = 512, seed: int = 0) -> SMPLData:
    """A small random-but-valid SMPL-like body: vertices on a capsule, a
    chain kinematic tree, smooth LBS weights."""
    rng = np.random.default_rng(seed)
    y = np.linspace(-1.0, 1.0, num_vertices).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, num_vertices).astype(np.float32)
    r = 0.25 * (1.0 - 0.5 * np.abs(y))
    v_template = np.stack([r * np.cos(theta), y, r * np.sin(theta)], -1)
    parents = np.arange(0, NUM_JOINTS - 1)
    joints_y = np.linspace(-1.0, 1.0, NUM_JOINTS).astype(np.float32)
    d = -np.abs(y[None, :] - joints_y[:, None]) * 20
    j_regressor = np.exp(d) / np.exp(d).sum(1, keepdims=True)
    w = np.exp(-np.abs(y[:, None] - joints_y[None, :]) * 8)
    lbs_weights = (w / w.sum(1, keepdims=True)).astype(np.float32)
    try:  # a closed triangulation, as in the JAX package
        from scipy.spatial import ConvexHull
        faces = ConvexHull(v_template).simplices.astype(np.int64)
    except ImportError:
        faces = np.zeros((1, 3), np.int64)
    return SMPLData(
        v_template=v_template,
        shapedirs=rng.normal(scale=0.01,
                             size=(num_vertices, 3, 10)).astype(np.float32),
        posedirs=rng.normal(scale=0.001,
                            size=(num_vertices, 3, 207)).astype(np.float32),
        j_regressor=j_regressor.astype(np.float32),
        lbs_weights=lbs_weights,
        parents=parents,
        faces=faces,
    )


def rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) by the
    reference's quaternion route: angle = |theta + 1e-8|."""
    l1 = torch.linalg.norm(theta + 1e-8, dim=-1, keepdim=True)
    axis = theta / l1
    half = l1 * 0.5
    q = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = qw * qw, qx * qx, qy * qy, qz * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    r = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return r.reshape(*theta.shape[:-1], 3, 3)


def _joint_transforms(data: SMPLData, pose: torch.Tensor, betas: torch.Tensor):
    """(G, v_posed): the (B, 24, 4, 4) rest-relative joint transforms and
    the pose-blended vertices."""
    b = pose.shape[0]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=pose.device)

    v_shaped = t(data.v_template) + torch.einsum("vck,bk->bvc",
                                                 t(data.shapedirs), betas)
    joints = torch.einsum("jv,bvc->bjc", t(data.j_regressor), v_shaped)
    rots = rodrigues(pose.reshape(b, NUM_JOINTS, 3))
    eye = torch.eye(3, device=pose.device)
    lrotmin = (rots[:, 1:] - eye).reshape(b, 207)
    v_posed = v_shaped + torch.einsum("vck,bk->bvc", t(data.posedirs), lrotmin)

    parents = torch.as_tensor(np.asarray(data.parents), device=pose.device)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parents]], dim=1)
    local = torch.cat([rots, rel[..., None]], dim=-1)           # (B,24,3,4)
    pad = torch.tensor([0.0, 0.0, 0.0, 1.0], device=pose.device).expand(
        b, NUM_JOINTS, 1, 4)
    local = torch.cat([local, pad], dim=-2)                      # (B,24,4,4)
    globals_ = [local[:, 0]]
    for i in range(1, NUM_JOINTS):
        globals_.append(globals_[int(data.parents[i - 1])] @ local[:, i])
    g = torch.stack(globals_, dim=1)
    rest = torch.cat([joints, joints.new_zeros((b, NUM_JOINTS, 1))],
                     dim=-1)[..., None]
    correction = torch.cat([g.new_zeros((b, NUM_JOINTS, 4, 3)), g @ rest],
                           dim=-1)
    return g - correction, v_posed


def smpl_forward(data: SMPLData, pose: torch.Tensor,
                 betas: torch.Tensor) -> torch.Tensor:
    """Posed vertices (B, V, 3) from pose (B, 72) and betas (B, 10)."""
    g, v_posed = _joint_transforms(data, pose, betas)
    w = torch.as_tensor(data.lbs_weights, dtype=torch.float32,
                        device=pose.device)
    tr = torch.einsum("vj,bjmn->bvmn", w, g)
    homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    return torch.einsum("bvmn,bvn->bvm", tr, homo)[..., :3]


def smpl_vertex_transforms(data: SMPLData, pose: torch.Tensor,
                           betas: torch.Tensor) -> torch.Tensor:
    """Per-vertex rest -> posed 4x4 transforms (B, V, 4, 4)."""
    g, _ = _joint_transforms(data, pose, betas)
    w = torch.as_tensor(data.lbs_weights, dtype=torch.float32,
                        device=pose.device)
    return torch.einsum("vj,bjmn->bvmn", w, g)
