"""ScenePack serialization (port of mitsuba_tpu/scene/serialize.py) — the
object-graph serialization analogue.

The reference streams serialized object graphs between cluster nodes
(include/mitsuba/core/serialization.h:35-65).  A ScenePack is flat
already, a dict of arrays plus a static meta dict, so its serialized form
is one compressed npz of the arrays with the meta as a JSON blob
(`.mtspack`, FORMAT_VERSION 3), the JAX package's format: a file written
by either package loads in the other.  `render(scene,
pack=load_pack(path))` skips XML parsing, geometry processing, the BVH
and cluster builds and texture packing.

    from mitsuba_tpu_torch.scene.serialize import save_pack, load_pack
    save_pack(pack_scene(scene), "scene.mtspack")
    img = render(scene, pack=load_pack("scene.mtspack"))

`save_pack` writes the reference's arrays and meta keys only: the port's
derived tables (scene/builder.py `_with_derived`, `_derived_meta`, and
the cache accel/pairs.py adds) are left out, and `load_pack` rebuilds
them through `pack_from_numpy`.  The port's pack holds the reference's
arrays that the port reads, a subset of the reference's pack: the JAX
package loads a port-written file and renders it where it needs no more
(the Cornell box; not a scene with media, whose medium tables it lacks).
bfloat16 tables are written as the reference's numpy writes ml_dtypes'
bfloat16, two raw bytes a value (dtype V2), and read back as bfloat16.
"""

from __future__ import annotations

import io
import json
import re

import numpy as np
import torch

FORMAT_VERSION = 3  # v3: cl_primf winner-select table (accel/clusters.py)

# the port's derived tables and meta keys, which the reference's pack
# lacks (cl_tri_rows: accel/pairs.py caches it in the pack at first use)
_DERIVED_ARRAY = re.compile(r"mat_params|mat_iparams|cl_cnt|ig\d+_cl_cnt|cl_tri_rows")
_DERIVED_META = ("tex_kinds", "tex_nearest_any")


def _meta_to_json(meta):
    def enc(v):
        if isinstance(v, tuple):
            return {"__tuple__": [enc(x) for x in v]}
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, np.bool_):
            return bool(v)
        return v

    return json.dumps({k: enc(v) for k, v in meta.items()})


def _meta_from_json(text):
    def dec(v):
        if isinstance(v, dict) and "__tuple__" in v:
            return tuple(dec(x) for x in v["__tuple__"])
        if isinstance(v, list):
            return tuple(dec(x) for x in v)
        return v

    return {k: dec(v) for k, v in json.loads(text).items()}


def _to_numpy(v):
    """A pack leaf as the reference's numpy writes it: bfloat16 as its
    raw bits (V2)."""
    if torch.is_tensor(v):
        if v.dtype == torch.bfloat16:
            return v.detach().cpu().view(torch.int16).numpy().view("V2")
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _from_numpy(v):
    """A leaf as read from an npz: a two-byte void array (the reference's
    bfloat16) comes back as a bfloat16 tensor on the host."""
    if v.dtype.kind == "V" and v.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(v).view(np.int16)).view(torch.bfloat16)
    return v


def save_pack(pack, path):
    """Write a ScenePack to one compressed .mtspack (npz) file, or as one
    length-prefixed blob to a writable `core.stream.Stream` (the
    reference ships serialized scenes over streams, serialization.h:35 and
    sched_remote.cpp ENewResource; here a SocketStream, ZStream or
    PipeStream)."""
    from mitsuba_tpu_torch.core.stream import Stream

    arrays = {k: _to_numpy(v) for k, v in pack.arrays.items() if not _DERIVED_ARRAY.fullmatch(k)}
    meta = {k: v for k, v in pack.meta.items() if k not in _DERIVED_META}

    def write_npz(f):
        np.savez_compressed(
            f,
            __meta__=np.frombuffer(_meta_to_json(meta).encode(), dtype=np.uint8),
            __version__=np.asarray([FORMAT_VERSION], np.int32),
            **arrays,
        )

    if isinstance(path, Stream):
        # npz needs a seekable file: stage it in memory, then one blob
        buf = io.BytesIO()
        write_npz(buf)
        path.write_blob(buf.getvalue())
        path.flush()
        return
    # through a file object, so that numpy appends no ".npz"
    with open(path, "wb") as f:
        write_npz(f)


def load_pack(path, device="cuda"):
    """Load a ScenePack written by either package's save_pack (a path or
    a Stream) onto `device` (the card unless the caller asks for
    another), with the port's derived tables rebuilt."""
    from mitsuba_tpu_torch.core.stream import Stream
    from mitsuba_tpu_torch.scene.builder import pack_from_numpy

    src = io.BytesIO(path.read_blob()) if isinstance(path, Stream) else path
    with np.load(src) as z:
        ver = int(z["__version__"][0])
        if ver != FORMAT_VERSION:
            raise ValueError(f"{path}: mtspack version {ver} != {FORMAT_VERSION}")
        meta = _meta_from_json(bytes(z["__meta__"]).decode())
        arrays = {k: _from_numpy(z[k]) for k in z.files if k not in ("__meta__", "__version__")}
    return pack_from_numpy(arrays, meta, device)
