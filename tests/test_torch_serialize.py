"""`.mtspack` files and streams across the two packages: the port's
scene/serialize.py and core/stream.py against the JAX package's.

* A pack the JAX package wrote loads in the port (its derived tables
  rebuilt, bfloat16 grids read back) equal to the port's own pack of the
  scene, and renders equal to it: cbox (brute force), smoke (clusters,
  media, the bfloat16 corner grid), the matpreview variant (textures).
* A pack the port wrote loads in the JAX package, equal to the JAX pack on
  every key it holds; the JAX package renders cbox from it equal to its
  own pack.
* The same across a MemoryStream, a ZStream and a SocketStream (a
  socketpair, and TCP on 127.0.0.1), each direction.
* The streams' typed writes give the reference's bytes in both byte
  orders, and each package reads the other's.
"""

import socket
import threading

import numpy as np
import pytest
import torch

import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu.core import stream as jstream
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.serialize import load_pack as jload_pack
from mitsuba_tpu.scene.serialize import save_pack as jsave_pack
from mitsuba_tpu_torch.core import stream as tstream
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.scene.serialize import FORMAT_VERSION, load_pack, save_pack
from tests.torch_meshes import ROOT, matpreview_const_xml, smoke_xml

torch.set_num_threads(1)

CBOX_XML = open(f"{ROOT}/scenes/cbox.xml").read()
SCENES = {"cbox": (CBOX_XML, 16), "smoke": (smoke_xml(), 16),
          "matpreview": (matpreview_const_xml(), 16)}


def _scenes(name):
    xml, size = SCENES[name]
    out = []
    for load in (mt.load_scene_string, mitsuba_tpu.load_scene_string):
        s = load(xml, base_dir=f"{ROOT}/scenes")
        s.sensor.record.film.width = s.sensor.record.film.height = size
        out.append(s)
    return out


def _assert_packs_equal(a, b):
    assert set(a.arrays) == set(b.arrays) and a.meta == b.meta
    for k, v in a.arrays.items():
        assert v.dtype == b.arrays[k].dtype and torch.equal(v, b.arrays[k]), k


@pytest.mark.parametrize("name", sorted(SCENES))
def test_reference_pack_loads_and_renders_in_the_port(tmp_path, name):
    scene, jscene = _scenes(name)
    path = str(tmp_path / "ref.mtspack")
    jsave_pack(jpack_scene(jscene), path)
    loaded = load_pack(path, device="cpu")
    own = pack_scene(scene, "cpu")
    assert set(own.arrays) <= set(loaded.arrays)
    for k, v in own.arrays.items():
        assert v.dtype == loaded.arrays[k].dtype and torch.equal(v, loaded.arrays[k]), k
    assert all(loaded.meta[k] == v for k, v in own.meta.items())
    if name == "smoke":
        assert loaded.arrays["het_corners"].dtype == torch.bfloat16
    a = mt.render(scene, spp=2, seed=1, device="cpu", pack=own)
    b = mt.render(scene, spp=2, seed=1, device="cpu", pack=loaded)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_port_pack_loads_in_the_reference(tmp_path, name):
    scene, jscene = _scenes(name)
    own = pack_scene(scene, "cpu")
    mt.render(scene, spp=1, device="cpu", pack=own)  # the pair pipeline's cache
    path = str(tmp_path / "port.mtspack")
    save_pack(own, path)
    with np.load(path) as z:
        assert int(z["__version__"][0]) == FORMAT_VERSION
        for k in ("mat_params", "mat_iparams", "cl_cnt", "cl_tri_rows"):
            assert k not in z.files
    back = jload_pack(path)
    ref = jpack_scene(jscene)
    assert set(back.arrays) <= set(ref.arrays)
    assert all(ref.meta[k] == v for k, v in back.meta.items())
    assert "tex_kinds" not in back.meta
    for k, v in back.arrays.items():
        r = np.asarray(ref.arrays[k])
        assert v.shape == r.shape and v.dtype.itemsize == r.dtype.itemsize, k
        assert v.tobytes() == r.tobytes(), k
    # the port reads its own file back to a fresh pack of the scene
    _assert_packs_equal(load_pack(path, device="cpu"), pack_scene(scene, "cpu"))
    if name == "cbox":
        np.testing.assert_array_equal(mitsuba_tpu.render(jscene, spp=2, pack=back),
                                      mitsuba_tpu.render(jscene, spp=2, pack=ref))


def _over(kind, write, read):
    """write(stream) on one end and read(stream) on the other of a `kind`
    transport, each through its package's stream classes (`_Fn`); returns
    read's result."""
    if kind == "memory":
        ws = write.stream_cls.MemoryStream()
        write(ws)
        rs = read.stream_cls.MemoryStream(ws.getvalue())
        return read(rs)
    if kind == "zstream":
        inner = write.stream_cls.MemoryStream()
        z = write.stream_cls.ZStream(inner)
        write(z)
        z.finish()
        rs = read.stream_cls.ZStream(read.stream_cls.MemoryStream(inner.getvalue()))
        return read(rs)
    if kind == "socketpair":
        a, b = socket.socketpair()
    else:  # TCP on the loopback
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        a = socket.create_connection(srv.getsockname(), timeout=30)
        b, _ = srv.accept()
        srv.close()
    ws, rs = write.stream_cls.SocketStream(a), read.stream_cls.SocketStream(b)
    t = threading.Thread(target=write, args=(ws,))
    t.start()
    try:
        return read(rs)
    finally:
        t.join(timeout=60)
        ws.close()
        rs.close()


class _Fn:
    """A function of a stream, with the stream module it takes."""

    def __init__(self, fn, stream_cls):
        self.fn, self.stream_cls = fn, stream_cls

    def __call__(self, s):
        return self.fn(s)


@pytest.mark.parametrize("kind", ["memory", "zstream", "socketpair", "tcp"])
def test_packs_over_streams(kind):
    scene, jscene = _scenes("smoke")
    own = pack_scene(scene, "cpu")
    ref = jpack_scene(jscene)
    # port -> JAX package
    back = _over(kind, _Fn(lambda s: save_pack(own, s), tstream), _Fn(jload_pack, jstream))
    for k, v in back.arrays.items():
        assert v.tobytes() == np.asarray(ref.arrays[k]).tobytes(), k
    # JAX package -> port
    loaded = _over(kind, _Fn(lambda s: jsave_pack(ref, s), jstream),
                   _Fn(lambda s: load_pack(s, device="cpu"), tstream))
    for k, v in own.arrays.items():
        assert torch.equal(v, loaded.arrays[k]), k
    np.testing.assert_array_equal(mt.render(scene, spp=1, device="cpu", pack=own),
                                  mt.render(scene, spp=1, device="cpu", pack=loaded))


def _write_all(s):
    s.write_bool(True)
    s.write_u8(200)
    s.write_i8(-100)
    s.write_u16(60000)
    s.write_i16(-30000)
    s.write_u32(4000000000)
    s.write_i32(-2000000000)
    s.write_u64(1 << 60)
    s.write_i64(-(1 << 60))
    s.write_f16(0.5)
    s.write_f32(3.25)
    s.write_f64(-1.0 / 3.0)
    s.write_string("héllo")
    s.write_line("a line")
    s.write_array(np.arange(7, dtype=np.float32) - 3)
    s.write_array(np.arange(5, dtype=np.int64) << 40)
    s.write_blob(b"blobby")
    s.flush()


def _read_all(s):
    return (s.read_bool(), s.read_u8(), s.read_i8(), s.read_u16(), s.read_i16(), s.read_u32(),
            s.read_i32(), s.read_u64(), s.read_i64(), s.read_f16(), s.read_f32(), s.read_f64(),
            s.read_string(), s.read_line(), s.read_array(np.float32, 7).tolist(),
            s.read_array(np.int64, 5).tolist(), s.read_blob())


@pytest.mark.parametrize("order", ["little", "big", "network"])
def test_stream_bytes_equal(order):
    ours, ref = tstream.MemoryStream(), jstream.MemoryStream()
    for s in (ours, ref):
        s.set_byte_order(order)
        _write_all(s)
    assert ours.getvalue() == ref.getvalue()
    assert ours.byte_order == ref.byte_order
    for src, dst in ((ours, jstream), (ref, tstream)):
        rs = dst.MemoryStream(src.getvalue())
        rs.set_byte_order(order)
        expect = jstream.MemoryStream(ref.getvalue())
        expect.set_byte_order(order)
        assert _read_all(rs) == _read_all(expect)


@pytest.mark.parametrize("kind", ["zstream", "socketpair", "tcp"])
def test_streams_across_packages(kind):
    expect = jstream.MemoryStream()
    _write_all(expect)
    expect.seek(0)
    want = _read_all(expect)
    assert _over(kind, _Fn(_write_all, tstream), _Fn(_read_all, jstream)) == want
    assert _over(kind, _Fn(_write_all, jstream), _Fn(_read_all, tstream)) == want


def test_file_pipe_and_mmap(tmp_path):
    """FileStream, PipeStream (through `cat`) and MemoryMappedFile hold the
    reference's contract: equal bytes and views."""
    p, q = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    with tstream.FileStream(p, "w") as f:
        _write_all(f)
    with jstream.FileStream(q, "w") as f:
        _write_all(f)
    assert open(p, "rb").read() == open(q, "rb").read()
    with tstream.FileStream(p, "r") as f:
        assert f.size() == len(open(q, "rb").read())
        assert _read_all(f)[-1] == b"blobby"
    pipe = tstream.PipeStream(["cat"])
    pipe.write_u32(7)
    pipe.write_string("x")
    pipe.flush()
    pipe.close_write()
    assert (pipe.read_u32(), pipe.read_string()) == (7, "x")
    pipe.close()
    np.arange(6, dtype=np.float32).tofile(p)
    with tstream.MemoryMappedFile(p) as m, jstream.MemoryMappedFile(p) as n:
        np.testing.assert_array_equal(m.view(np.float32), n.view(np.float32))
    with pytest.raises(tstream.EOFError_):
        tstream.MemoryStream(b"abc").read(5)
