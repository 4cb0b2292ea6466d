"""Writes the benchmark's plain scene (benchmark/scene.py) as a glTF 2.0
file, the form in which users hand a scene to the program: a .gltf, one
.bin buffer and a PNG a texture. The port loads it with its own loader
(tauray_torch.app.main.load_scenes), as the command line does.

Every entity becomes a node in the records' order, every model a mesh
(shared models stay shared), every material a glTF material. Lights go
through KHR_lights_punctual with their angle and radius in tauray's
TR_data extension; the port's loader divides a point light's intensity by
4 pi, so it is written times 4 pi. A directional light shines along its
node's -z: the records' `direction` is not carried, as the program's own
proc://sponza does not carry it either. Nothing here imports the
program."""

from __future__ import annotations

import json
import math
import os
import struct
import zlib
from typing import Dict, List

import numpy as np

from . import scene as bscene


def png_bytes(img: np.ndarray) -> bytes:
    """An (H, W, 4) uint8 image as an uncompressed-filter RGBA PNG."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class _Buffer:
    """The .bin buffer with its buffer views and accessors."""

    def __init__(self):
        self.parts: List[bytes] = []
        self.size = 0
        self.views: List[dict] = []
        self.accessors: List[dict] = []

    def add(self, arr: np.ndarray, kind: str, component: int,
            target: int, bounds: bool = False) -> int:
        data = np.ascontiguousarray(arr).tobytes()
        pad = (-self.size) % 4
        self.parts.append(b"\x00" * pad + data)
        self.size += pad
        self.views.append(dict(buffer=0, byteOffset=self.size,
                               byteLength=len(data), target=target))
        self.size += len(data)
        acc = dict(bufferView=len(self.views) - 1, componentType=component,
                   count=int(arr.shape[0]), type=kind)
        if bounds:
            acc["min"] = [float(v) for v in arr.min(axis=0)]
            acc["max"] = [float(v) for v in arr.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1


def write_gltf(plain: bscene.Scene, directory: str,
               name: str = "scene") -> str:
    """Writes `plain` into `directory` as <name>.gltf, <name>.bin and
    <name>_tex<k>.png; returns the .gltf's path."""
    os.makedirs(directory, exist_ok=True)
    buf = _Buffer()
    j: Dict[str, list] = {k: [] for k in (
        "images", "textures", "materials", "meshes", "nodes", "cameras")}
    j["samplers"] = [dict(wrapS=10497, wrapT=10497)]
    for k, tex in enumerate(getattr(plain, "textures", [])):
        uri = f"{name}_tex{k}.png"
        with open(os.path.join(directory, uri), "wb") as f:
            f.write(png_bytes(np.asarray(tex, np.uint8)))
        j["images"].append(dict(uri=uri))
        j["textures"].append(dict(source=k, sampler=0))

    mats: Dict[int, int] = {}
    meshes: Dict[int, int] = {}

    def material(m: bscene.Material) -> int:
        if id(m) not in mats:
            pbr = dict(baseColorFactor=[float(v) for v in m.albedo_factor],
                       metallicFactor=float(m.metallic_factor),
                       roughnessFactor=float(m.roughness_factor))
            if m.albedo_tex >= 0:
                pbr["baseColorTexture"] = dict(index=int(m.albedo_tex))
            g = dict(name=m.name, pbrMetallicRoughness=pbr,
                     doubleSided=bool(m.double_sided))
            if m.alpha_cutoff >= 0:
                g.update(alphaMode="MASK", alphaCutoff=float(m.alpha_cutoff))
            j["materials"].append(g)
            mats[id(m)] = len(j["materials"]) - 1
        return mats[id(m)]

    def mesh(model: bscene.Model) -> int:
        if id(model) not in meshes:
            prims = []
            for mat, me in model.groups:
                prims.append(dict(
                    attributes=dict(
                        POSITION=buf.add(me.positions, "VEC3", 5126, 34962,
                                         bounds=True),
                        TEXCOORD_0=buf.add(me.uvs, "VEC2", 5126, 34962)),
                    indices=buf.add(me.indices.reshape(-1).astype(
                        np.uint32), "SCALAR", 5125, 34963),
                    material=material(mat)))
            j["meshes"].append(dict(primitives=prims))
            meshes[id(model)] = len(j["meshes"]) - 1
        return meshes[id(model)]

    lights: List[dict] = []
    for e in plain.entities:
        node = dict(name=e.name)
        tr = e.transform
        if tr is not None:
            node.update(translation=[float(v) for v in tr.position],
                        rotation=[float(v) for v in tr.orientation],
                        scale=[float(v) for v in tr.scaling])
        if e.model is not None:
            node["mesh"] = mesh(e.model)
        if e.camera is not None:
            c = e.camera
            j["cameras"].append(dict(type="perspective", perspective=dict(
                yfov=math.radians(c.fov), aspectRatio=float(c.aspect),
                znear=float(c.near), zfar=float(c.far))))
            node["camera"] = len(j["cameras"]) - 1
        light = None
        if isinstance(e.light, bscene.DirectionalLight):
            light = dict(type="directional",
                         color=[float(v) for v in e.light.color])
            node["extensions"] = dict(TR_data=dict(light=dict(
                angle=math.radians(e.light.angle))))
        elif isinstance(e.light, bscene.PointLight):
            light = dict(type="point", color=[
                float(v) for v in e.light.color * np.float32(4 * math.pi)])
            node["extensions"] = dict(TR_data=dict(light=dict(
                radius=float(e.light.radius))))
        if light is not None:
            lights.append(light)
            node.setdefault("extensions", {})["KHR_lights_punctual"] = dict(
                light=len(lights) - 1)
        j["nodes"].append(node)

    binary = b"".join(buf.parts)
    with open(os.path.join(directory, f"{name}.bin"), "wb") as f:
        f.write(binary)
    doc = dict(asset=dict(version="2.0", generator="benchmark/gltf_writer"),
               scene=0, scenes=[dict(nodes=list(range(len(j["nodes"]))))],
               buffers=[dict(uri=f"{name}.bin", byteLength=len(binary))],
               bufferViews=buf.views, accessors=buf.accessors,
               extensionsUsed=["KHR_lights_punctual"],
               extensions=dict(KHR_lights_punctual=dict(lights=lights)),
               **{k: v for k, v in j.items() if v})
    path = os.path.join(directory, f"{name}.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
