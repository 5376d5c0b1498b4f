"""Carry state from the JAX package into the port.

Each function takes a JAX object's leaves as numpy arrays, one entry per
dataclass field (`np.asarray` of each field; nested dataclasses as nested
mappings), and returns the port's object on `device`. The tests use
accel_from_arrays to feed ONE accel to both packages, which holds the
traversal kernels to each other independently of the two accel builds,
flat_bvh_from_arrays to walk the reference's own LBVH with the port's
traversal, and fit_state_from_arrays to start both packages' fits from one
state.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tracer_torch.bvh.cluster import ClusterAccel
from tracer_torch.bvh.lbvh import FlatBVH
from tracer_torch.core.camera import Camera
from tracer_torch.scene.types import Lights, Materials, Scene


def _build(cls, fields: Mapping, device):
    return cls(**{name: torch.as_tensor(np.array(fields[name]), device=device)
                  for name in cls.__dataclass_fields__})


def scene_from_arrays(fields: Mapping, device) -> Scene:
    """Scene from {verts, tris, mat_id, normals, materials: {albedo,
    emission, mirror, specular, shininess}, lights: {position, intensity}}."""
    flat = {k: fields[k] for k in ("verts", "tris", "mat_id", "normals")}
    return Scene(materials=_build(Materials, fields["materials"], device),
                 lights=_build(Lights, fields["lights"], device),
                 **{k: torch.as_tensor(np.array(v), device=device) for k, v in flat.items()})


def camera_from_arrays(fields: Mapping, device) -> Camera:
    """Camera from {position, look_at, up, fov_y}."""
    return _build(Camera, fields, device)


def accel_from_arrays(fields: Mapping, device) -> ClusterAccel:
    """ClusterAccel from {tri_w, tri_ids, cluster_lo, cluster_hi, super_lo,
    super_hi, shade}."""
    return _build(ClusterAccel, fields, device)


def flat_bvh_from_arrays(fields: Mapping, device) -> FlatBVH:
    """FlatBVH from {node_lo, node_hi, left, right, leaf_tri}."""
    return _build(FlatBVH, fields, device)


def fit_state_from_arrays(params: Mapping, mu: Mapping, nu: Mapping, count: int, device):
    """A reference fit's state -> the port's: (params, adam_state).

    params, mu, nu: {name: array} (the fit's parameters and its optax Adam
    state's first and second moments); count: the Adam step count. Returns
    the parameters as leaf tensors that require grad, in the order of
    `params` (which must be the order of the optimizer's parameters:
    diff.fit.init_params' order, "vert_offset" then "albedo"), and the
    "state" entry of a torch.optim.Adam state_dict over them: for parameter
    i, {"step", "exp_avg", "exp_avg_sq"} (the step count as a float32
    tensor, as Adam keeps it)."""
    out = {k: torch.as_tensor(np.array(v), device=device).requires_grad_(True)
           for k, v in params.items()}
    state = {i: {"step": torch.tensor(float(count)),
                 "exp_avg": torch.as_tensor(np.array(mu[k]), device=device),
                 "exp_avg_sq": torch.as_tensor(np.array(nu[k]), device=device)}
             for i, k in enumerate(params)}
    return out, state
