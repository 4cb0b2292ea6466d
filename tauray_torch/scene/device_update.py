"""On-device per-frame scene update; the torch counterpart of
tauray_tpu.scene.device_update (reference: shader/skinning.comp +
shader/pre_transform.comp + shader/extract_tri_lights.comp, dispatched by
src/scene_stage.cc record_skinning/record_pre_transform/
record_tri_light_extraction).

Object-space geometry and the skinning tables upload once (GeomStatic).
Each frame the host walks the transform hierarchy only and supplies the
per-instance and per-joint matrices (small); the device skins and
transforms every triangle corner, repacks the shading table and refreshes
the triangle-light rows, so animated scenes never run per-triangle host
numpy or re-upload the soup."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.sampling import cross
from .arrays import SceneArrays, _normal_matrix
from .device import (IP_COLS, TL_COLS, TL_EMISSION, TL_POS, TL_TEX,
                     TL_TEXBLOCK, TL_TEXSIZE, TL_UV, TP_COLS, TP_IP,
                     _pack_lights, _tensor, resolve_device)


class GeomStatic(NamedTuple):
    """Uploaded once per topology change."""
    obj_pos: Any        # (T, 3, 3) f32 object-space corners
    obj_normal: Any     # (T, 3, 3)
    obj_tangent: Any    # (T, 3, 4)
    uv_flat: Any        # (T, 6)
    tri_instance: Any   # (T,) i32
    corner_joint: Any   # (T, 3, 4) i32 into the global joint table
    corner_weight: Any  # (T, 3, 4) f32 (all-zero rows = unskinned); both
                        # (0, 3, 4) when no instance is skinned
    tl_tri_index: Any   # (L,) i32
    tl_static: Any      # (L, TL_COLS) f32 with emission/uv/tex prefilled


def _geom_static_numpy(sa: SceneArrays) -> Tuple[Dict[str, np.ndarray], bool]:
    """The GeomStatic tables as numpy arrays, and whether any instance is
    skinned. The joint table holds each skinned instance's joints in
    instance order (host_frame_inputs stacks them the same way), so a
    corner's joint index is offset by the joints of the skinned instances
    before it."""
    T = sa.obj_pos.shape[0]
    has_skin = any(ig.joints is not None for ig in sa.instances)
    # with no skinned instance the corner tables are empty: update_geometry
    # never reads them, and they would hold 96 bytes a triangle
    Ts = T if has_skin else 0
    cj = np.zeros((Ts, 3, 4), np.int32)
    cw = np.zeros((Ts, 3, 4), np.float32)
    joint_base = 0
    tri_offset = 0
    for ig in sa.instances:
        ntri = len(ig.indices)
        if ig.joints is not None:
            idx = ig.indices                       # (ntri, 3)
            cj[tri_offset:tri_offset + ntri] = ig.joints[idx] + joint_base
            cw[tri_offset:tri_offset + ntri] = ig.weights[idx]
            e = sa.scene.entities[ig.entity_index]
            joint_base += len(e.model.joint_nodes)
        tri_offset += ntri

    L = sa.tl_pos.shape[0]
    tls = np.zeros((L, TL_COLS), np.float32)
    tls[:, TL_EMISSION:TL_EMISSION + 3] = sa.tl_emission
    tls[:, TL_UV:TL_UV + 6] = sa.tl_uv.reshape(L, 6)
    tls[:, TL_TEX] = sa.tl_tex
    sz = sa.texture_size[np.maximum(sa.tl_tex, 0)]
    tls[:, TL_TEXSIZE:TL_TEXSIZE + 2] = np.where(sa.tl_tex[:, None] >= 0,
                                                 sz, 1)
    blk = sa.tex_meta[np.maximum(sa.tl_tex, 0), 0, :2]
    tls[:, TL_TEXBLOCK:TL_TEXBLOCK + 2] = np.where(
        sa.tl_tex[:, None] >= 0, blk, 0)
    return dict(
        obj_pos=sa.obj_pos, obj_normal=sa.obj_normal,
        obj_tangent=sa.obj_tangent, uv_flat=sa.obj_uv.reshape(T, 6),
        tri_instance=sa.tri_instance, corner_joint=cj, corner_weight=cw,
        tl_tri_index=sa.tl_tri_index, tl_static=tls), has_skin


def geom_static_from_numpy(fields: Dict[str, Any], device) -> GeomStatic:
    """GeomStatic from a {field: numpy array} dict with this class's field
    names (for example tauray_tpu's GeomStatic fields via np.asarray)."""
    return GeomStatic(**{k: _tensor(np.asarray(fields[k]), device)
                         for k in GeomStatic._fields})


def build_geom_static(sa: SceneArrays, device=None
                      ) -> Tuple[GeomStatic, bool]:
    """Host-side one-time build. Returns (static tables on `device`,
    has_skinning). device=None means the CUDA card (raises without
    one)."""
    fields, has_skin = _geom_static_numpy(sa)
    return geom_static_from_numpy(fields, resolve_device(device)), has_skin


def host_frame_inputs(sa: SceneArrays):
    """Per-frame host work: walk the transform hierarchy only.
    Returns (inst_model (I,4,4), inst_normal (I,3,3), joints (J,4,4)) as
    numpy arrays."""
    insts = sa.instances
    I = max(len(insts), 1)
    models = np.tile(np.eye(4, dtype=np.float32), (I, 1, 1))
    normal_ms = np.tile(np.eye(3, dtype=np.float32), (I, 1, 1))
    joints_l = []
    for i, ig in enumerate(insts):
        e = sa.scene.entities[ig.entity_index]
        t = e.transform
        m = t.get_global_transform() if t is not None else np.eye(
            4, dtype=np.float32)
        models[i] = m
        normal_ms[i] = _normal_matrix(m)
        if ig.joints is not None:
            model = e.model
            jm = np.stack([j.get_global_transform()
                           for j in model.joint_nodes])
            if model.inverse_bind_matrices is not None:
                jm = np.einsum("jab,jbc->jac", jm,
                               model.inverse_bind_matrices)
            inv_m = np.linalg.inv(m) if t is not None else np.eye(4)
            jm = np.einsum("ab,jbc->jac", inv_m, jm)
            joints_l.append(jm.astype(np.float32))
    if joints_l:
        joints = np.concatenate(joints_l)
    else:
        joints = np.eye(4, dtype=np.float32)[None]
    return models, normal_ms, joints


class GeomFrame(NamedTuple):
    tri_pos: torch.Tensor        # (T, 3, 3) world-space
    tri_normal: torch.Tensor
    tri_tangent: torch.Tensor    # (T, 3, 4)
    tri_hard_normal: torch.Tensor  # (T, 3)


def update_geometry(gs: GeomStatic, inst_model, inst_normal, joints,
                    has_skin: bool) -> GeomFrame:
    """Skinning + world transform (reference: shader/skinning.comp +
    shader/pre_transform.comp). inst_model (I, 4, 4), inst_normal
    (I, 3, 3) and joints (J, 4, 4) are tensors on gs's device."""
    pos = gs.obj_pos
    nrm = gs.obj_normal
    tan3 = gs.obj_tangent[..., :3]
    if has_skin:
        # linear blend skinning per corner (reference: shader/skinning.comp)
        jm = joints[gs.corner_joint.long()]             # (T, 3, 4, 4, 4)
        vm = torch.einsum("tck,tckab->tcab", gs.corner_weight, jm)
        rot = vm[..., :3, :3]
        p_skin = torch.einsum("tcab,tcb->tca", rot, pos) + vm[..., :3, 3]
        n_skin = torch.einsum("tcab,tcb->tca", rot, nrm)
        t_skin = torch.einsum("tcab,tcb->tca", rot, tan3)
        skinned = (gs.corner_weight.sum(-1) > 0)[..., None]
        pos = torch.where(skinned, p_skin, pos)
        nrm = torch.where(skinned, n_skin, nrm)
        tan3 = torch.where(skinned, t_skin, tan3)

    inst = gs.tri_instance.clamp(min=0).long()
    m = inst_model[inst]                                # (T, 4, 4)
    nm = inst_normal[inst]                              # (T, 3, 3)
    world_pos = torch.einsum("tij,tcj->tci", m[:, :3, :3], pos) + \
        m[:, None, :3, 3]
    world_n = torch.einsum("tij,tcj->tci", nm, nrm)
    world_t = torch.einsum("tij,tcj->tci", nm, tan3)
    # hard normal from the OBJECT-space cross transformed by the normal
    # matrix (handles mirrored instances; reference: rt.glsl
    # get_interpolated_vertex). The cross takes separate products, no
    # FMA, so a triangle whose edges are equal in float32 gets a zero
    # normal, as on the host path, not a unit vector of rounding noise
    hard = cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    hard = torch.einsum("tij,tj->ti", nm, hard)
    hard = hard / torch.clamp(
        torch.linalg.norm(hard, dim=-1, keepdim=True), min=1e-30)
    tri_tangent = torch.cat([world_t, gs.obj_tangent[..., 3:]], dim=-1)
    return GeomFrame(world_pos, world_n, tri_tangent, hard)


def pack_frame(gs: GeomStatic, g: GeomFrame, prev_pos, inst_packed
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tri_packed, tl_packed, tl_pos) from the frame geometry, in the
    TP_*/TL_* layouts of scene/device.py. tri_packed rows are in original
    triangle order."""
    T = g.tri_pos.shape[0]
    inst = gs.tri_instance.clamp(min=0).long()
    tri_packed = torch.cat([
        g.tri_pos.reshape(T, 9),
        prev_pos.reshape(T, 9),
        g.tri_normal.reshape(T, 9),
        gs.uv_flat,
        g.tri_tangent.reshape(T, 12),
        g.tri_hard_normal,
        gs.tri_instance[:, None].to(torch.float32),
        inst_packed[inst],
        g.tri_pos.new_zeros((T, TP_COLS - TP_IP - IP_COLS)),
    ], dim=1)
    tl_pos = g.tri_pos[gs.tl_tri_index.long()]          # (L, 3, 3)
    L = tl_pos.shape[0]
    tl_packed = gs.tl_static.clone()
    tl_packed[:, TL_POS:TL_POS + 9] = tl_pos.reshape(L, 9)
    return tri_packed, tl_packed, tl_pos


def apply_frame_update(device_scene, gs: GeomStatic, g: GeomFrame,
                       prev: Optional[GeomFrame], sa: SceneArrays):
    """The DeviceScene with its per-frame fields replaced (static tables
    untouched). The light parameter tables are rebuilt on the host (they
    are tiny), so animated lights stay correct. With no previous frame,
    the previous positions are this frame's, as in tauray_tpu."""
    dev = device_scene.tri_packed.device
    prev_pos = prev.tri_pos if prev is not None else g.tri_pos
    tri_packed, tl_packed, tl_pos = pack_frame(gs, g, prev_pos,
                                               device_scene.inst_packed)
    pl_packed, dl_packed, _ = _pack_lights(sa)
    return device_scene._replace(
        tri_pos=g.tri_pos,
        tri_normal=g.tri_normal,
        tri_tangent=g.tri_tangent,
        tri_hard_normal=g.tri_hard_normal,
        tri_pos_prev=prev_pos,
        tri_packed=tri_packed,
        tl_packed=tl_packed,
        tl_pos=tl_pos,
        pl_packed=_tensor(pl_packed, dev),
        dl_packed=_tensor(dl_packed, dev),
        pl_color=_tensor(sa.pl_color, dev),
        pl_pos=_tensor(sa.pl_pos, dev),
        pl_dir=_tensor(sa.pl_dir, dev),
        dl_color=_tensor(sa.dl_color, dev),
        dl_dir=_tensor(sa.dl_dir, dev))
