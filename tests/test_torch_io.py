"""The port's copies of the JAX package's I/O: PCD reading (ascii, binary,
LZF-compressed, extra fields) of files the JAX package writes, padding and
q16 fixed point, the frame source, every artifact file byte for byte (the
YAML written without pyyaml included), the observables' packed layout and
the checkpoint archive's keys."""

import contextlib
import filecmp
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from datmo_using_optical_flow_tpu.config import PipelineAConfig as JConfig
from datmo_using_optical_flow_tpu.io import artifacts as jart
from datmo_using_optical_flow_tpu.io import frames as jfr
from datmo_using_optical_flow_tpu.io import pcd as jpcd
from datmo_using_optical_flow_tpu.models.optical_flow_datmo import PipelineA as JPipelineA
from datmo_using_optical_flow_tpu.models.optical_flow_datmo import _cached_obs_pack
from datmo_using_optical_flow_tpu.utils import checkpoint as jckpt
from datmo_using_optical_flow_tpu_torch.config import PipelineAConfig
from datmo_using_optical_flow_tpu_torch.io import artifacts as tart
from datmo_using_optical_flow_tpu_torch.io import frames as tfr
from datmo_using_optical_flow_tpu_torch.io import pcd as tpcd
from datmo_using_optical_flow_tpu_torch.models.optical_flow_datmo import (PipelineA, StepOutputs,
                                                                          obs_packer)
from datmo_using_optical_flow_tpu_torch.models.tracker_a import TrackTable
from datmo_using_optical_flow_tpu_torch.utils import checkpoint as tckpt
from datmo_using_optical_flow_tpu_torch.utils.hostpack import HostMirror, HostPacker
from datmo_using_optical_flow_tpu_torch.utils.state import carry_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture
def points():
    return np.random.default_rng(42).normal(scale=8.0, size=(500, 3)).astype(np.float32)


@pytest.mark.parametrize("encoding", ["ascii", "binary"])
@pytest.mark.parametrize("use_native", [True, False])
def test_pcd_written_by_jax_reads_the_same(tmp_path, points, encoding, use_native):
    p = str(tmp_path / "t.pcd")
    jpcd.write_pcd(p, points, encoding)
    got = tpcd.read_pcd(p, dtype=np.float32, use_native=use_native)
    np.testing.assert_array_equal(got, jpcd.read_pcd(p, dtype=np.float32, use_native=use_native))
    np.testing.assert_allclose(got, points, rtol=1e-6, atol=1e-6)
    q = str(tmp_path / "port.pcd")
    tpcd.write_pcd(q, points, encoding)
    assert filecmp.cmp(p, q, shallow=False)


def _lzf(data: bytes, offset: int = 16) -> bytes:
    """A valid LZF stream: back references at a fixed offset where the data
    repeats, literal runs elsewhere."""
    out, lit, i = bytearray(), bytearray(), 0

    def flush():
        for s in range(0, len(lit), 32):
            run = lit[s:s + 32]
            out.append(len(run) - 1)
            out.extend(run)
        lit.clear()

    while i < len(data):
        n = 0
        while (i >= offset and i + n < len(data) and n < 264
               and data[i + n] == data[i + n - offset]):
            n += 1
        if n >= 3:
            flush()
            length, ref = n - 2, offset - 1
            if length < 7:
                out.append((length << 5) | (ref >> 8))
            else:
                out += bytes([(7 << 5) | (ref >> 8), length - 7])
            out.append(ref & 0xFF)
            i += n
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def test_pcd_binary_compressed_and_extra_fields(tmp_path, points):
    pts = points.copy()
    pts[100:300] = np.tile(pts[96:100], (50, 1))  # repeats: LZF back references
    soa = np.concatenate([pts[:, 0], pts[:, 1], pts[:, 2]]).astype("<f4").tobytes()
    comp = _lzf(soa)
    assert len(comp) < len(soa) and tpcd._lzf_decompress(comp, len(soa)) == soa
    hdr = ("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
           f"WIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\nDATA binary_compressed\n")
    p = str(tmp_path / "c.pcd")
    with open(p, "wb") as f:
        f.write(hdr.encode() + struct.pack("<II", len(comp), len(soa)) + comp)
    for use_native in (True, False):
        np.testing.assert_array_equal(tpcd.read_pcd(p, np.float32, use_native), pts)
    rec = np.zeros(len(pts), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("i", "<f4")])
    rec["x"], rec["y"], rec["z"] = pts.T
    hdr = ("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
           f"WIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\nDATA binary\n")
    q = str(tmp_path / "i.pcd")
    with open(q, "wb") as f:
        f.write(hdr.encode() + rec.tobytes())
    np.testing.assert_array_equal(tpcd.read_pcd(q, np.float32, False), pts)
    with open(str(tmp_path / "bad.pcd"), "wb") as f:
        f.write(b"VERSION 0.7\nFIELDS x y z\n")
    with pytest.raises(ValueError, match="truncated"):
        tpcd.read_pcd(str(tmp_path / "bad.pcd"), use_native=False)


@pytest.mark.parametrize("n", [0, 10, 64, 80])
def test_padding_and_q16_equal_jax(points, n):
    pts = points[:n]
    with pytest.warns(UserWarning) if n > 64 else contextlib.nullcontext():
        got = tfr.pad_points(pts, 64)
    with pytest.warns(UserWarning) if n > 64 else contextlib.nullcontext():
        want = jfr.pad_points(pts, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.warns(UserWarning) if n > 64 else contextlib.nullcontext():
        got = tfr.pad_points_q16(pts * 4.0, 64)   # beyond +-32 m: clipped
    with pytest.warns(UserWarning) if n > 64 else contextlib.nullcontext():
        want = jfr.pad_points_q16(pts * 4.0, 64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    deq = tfr.dequantize_points_q16(torch.as_tensor(got[0]))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jfr.dequantize_points_q16(
        jnp.asarray(got[0]))))


def test_frame_source_and_natsort_equal_jax(tmp_path, points):
    names = [f"lidar_frame_{i}.pcd" for i in (930, 1200, 990, 30, 1020)]
    assert sorted(names, key=tfr.natsort_key) == sorted(names, key=jfr.natsort_key)
    for k, name in enumerate(names):
        jpcd.write_pcd(str(tmp_path / name), points[:100 + k])
    (tmp_path / names[2]).write_bytes(b"garbage")  # a corrupt frame is delivered empty
    for q16 in (False, True):
        got = list(tfr.DiskFrameSource(folder=str(tmp_path), capacity=128, quantize_q16=q16))
        want = list(jfr.DiskFrameSource(folder=str(tmp_path), capacity=128, quantize_q16=q16))
        assert len(got) == len(want) == 5
        for (gp, gm), (wp, wm) in zip(got, want):
            np.testing.assert_array_equal(gp, wp)
            np.testing.assert_array_equal(gm, wm)
        assert got[2][1].sum() == 0 or got[1][1].sum() == 0


def _sink_inputs(seed: int):
    rng = np.random.default_rng(seed)
    vx = rng.normal(size=(20, 24)).astype(np.float32)
    vy = rng.normal(size=(20, 24)).astype(np.float32)
    vx[rng.uniform(size=vx.shape) < 0.6] = 0.0
    vy[vx == 0.0] = 0.0
    tracks = {int(t): rng.normal(scale=10.0, size=4).astype(np.float32)
              for t in rng.integers(0, 500, 3)}
    return vx, vy, tracks


def test_artifacts_byte_equal_to_jax(tmp_path):
    dirs = {}
    for name, mod in (("jax", jart), ("port", tart)):
        sink = mod.ArtifactSink(str(tmp_path / name), save_png=False)
        for i in range(3):
            vx, vy, tracks = _sink_inputs(i)
            sink.save_bev((np.abs(vx) * 100).astype(np.uint8), i)
            sink.save_velocity_grid(vx, vy, i)
            mag = np.sqrt(vx * vx + vy * vy)
            sink.append_filtered_velocities(vx, vy, mag, vx - vy, i)
            idx = np.argwhere(vx != 0).astype(np.int32)
            sink.save_dbscan_results(np.arange(len(idx), dtype=np.int32) % 3, idx, i)
            sink.save_ekf_tracks(tracks if i else {}, i)
            sink.append_track_velocities(tracks, i)
        dirs[name] = str(tmp_path / name)
    files = sorted(os.listdir(dirs["jax"]))
    assert files == sorted(os.listdir(dirs["port"])) and len(files) == 20
    for f in files:
        assert filecmp.cmp(os.path.join(dirs["jax"], f), os.path.join(dirs["port"], f),
                           shallow=False), f


def test_yaml_text_equals_yaml_dump():
    rng = np.random.default_rng(0)
    cases = [{}, {3: [1.0, 2.5, -0.1, 1e-05]}, {10: [1e17, -0.0, 0.0, 123456789.123]},
             {1: [float("nan"), float("inf"), -float("inf"), 1e-300]}]
    for _ in range(200):
        n = int(rng.integers(0, 6))
        scale = 10.0 ** float(rng.integers(-8, 9))
        cases.append({int(k): [float(np.float32(x)) for x in rng.normal(scale=scale, size=4)]
                      for k in rng.integers(-5, 100000, n)})
    for case in cases:
        assert tart.yaml_tracks(case) == yaml.dump(case), case


def test_packed_observables_equal_jax_layout():
    """The same frame observables pack to the same bytes in both packages,
    and unpack to the same tree."""
    cfg, jcfg = PipelineAConfig(), JConfig()
    pack, packer = obs_packer(cfg)
    jpack, jpacker = _cached_obs_pack(jcfg)
    assert packer.nbytes == jpacker.nbytes
    rng = np.random.default_rng(1)
    jp = JPipelineA(jcfg)
    jout = jax.tree.map(lambda s: jnp.asarray(rng.integers(0, 50, s.shape).astype(s.dtype)),
                        jax.eval_shape(lambda: jp.step(jnp.zeros((200, 200), jnp.uint8),
                                                       jnp.zeros((200, 200), jnp.uint8),
                                                       jp.init_carry())[1]))
    bev = rng.integers(0, 255, (200, 200)).astype(np.uint8)
    want = np.asarray(jpack(jnp.asarray(bev), jout))
    host = jax.device_get(jout)
    tout = StepOutputs(*(torch.as_tensor(np.array(x)) for x in host[:-1]),
                       TrackTable(*(torch.as_tensor(np.array(x)) for x in host.snapshot)))
    got = pack(torch.as_tensor(bev), tout)
    np.testing.assert_array_equal(got.numpy(), want)
    stacked = HostPacker.stack([got, got]).numpy()
    tree, jtree = packer.unpack(stacked[1]), jpacker.unpack(want)
    assert sorted(tree) == sorted(jtree)
    for k in tree:
        for a, b in zip(jax.tree.leaves(tree[k]), jax.tree.leaves(jtree[k])):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_host_mirror_order_and_first_error():
    """Frames reach the mirror in order, batched copies included; a
    mirror's error is re-raised in the loop's thread and later frames are
    not mirrored; ``close`` itself never raises."""
    packer = HostPacker({"x": torch.empty((3,), dtype=torch.int32, device="meta")})
    seen = []
    mirror = HostMirror(packer, lambda i, obs: seen.append((i, obs["x"].tolist())))
    for i in range(40):
        mirror.put(i, packer.pack({"x": torch.tensor([i, i + 1, i + 2], dtype=torch.int32)}))
    mirror.flush()
    mirror.close()
    mirror.check()
    assert seen == [(i, [i, i + 1, i + 2]) for i in range(40)]

    def fail_at_3(i, obs):
        if i == 3:
            raise ValueError("disk full")
        seen.append(i)

    seen.clear()
    mirror = HostMirror(packer, fail_at_3)
    with pytest.raises(ValueError, match="disk full"):
        for i in range(10):
            mirror.put(i, packer.pack({"x": torch.zeros(3, dtype=torch.int32)}))
            mirror.flush()
    mirror.close()
    with pytest.raises(ValueError, match="disk full"):
        mirror.check()
    assert seen == [0, 1, 2]


def test_checkpoint_keys_and_values_equal_jax(tmp_path):
    cfg = PipelineAConfig(x_range=(-4.0, 4.0), y_range=(-4.0, 4.0))
    jcarry = JPipelineA(JConfig(x_range=(-4.0, 4.0), y_range=(-4.0, 4.0))).init_stream_carry()
    jcarry = jax.tree.map(lambda x: x + 1 if x.dtype != jnp.bool_ else ~x, jcarry)
    carry = carry_from_numpy(jax.device_get(jcarry), "cpu")
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), jcarry, step=7)
    tckpt.save_checkpoint(str(tmp_path / "t.npz"), carry, step=7)
    with np.load(str(tmp_path / "j.npz")) as j, np.load(str(tmp_path / "t.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(j[k], t[k], err_msg=k)
    like = PipelineA(cfg, "cpu").init_stream_carry()
    back = tckpt.load_checkpoint(str(tmp_path / "j.npz"), like)
    for a, b in zip(jax.tree.leaves(tuple(jax.device_get(jcarry))), _leaves(back)):
        np.testing.assert_array_equal(a, b.numpy())
    with pytest.raises(ValueError, match="npz"):
        tckpt.save_checkpoint(str(tmp_path / "dir"), carry)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]
