"""Wire formats the port shares with the JAX package, byte for byte.

Frames (plain, truncated, coalesced BATCH, PUBLISH hop, flagged), hop
headers, rendezvous descriptors and ``FBC1`` fat-bitcode archives packed by
either package must unpack in the other, and the calibrated wire tables
must be equal."""

import dataclasses
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import repro.core.bitcode as jax_bitcode
import repro.core.frame as jax_frame
import repro.core.transport as jax_transport
import repro_torch.core.bitcode as torch_bitcode
import repro_torch.core.frame as torch_frame
import repro_torch.core.transport as torch_transport

PAIRS = {"jax->torch": (jax_frame, torch_frame), "torch->jax": (torch_frame, jax_frame)}


def _frames(m):
    """One of each frame shape, built with module ``m``."""
    base = dict(
        kind=m.FrameKind.BITCODE, name="gatherer", payload=b"\x01\x02\x03\x04",
        code=b"C" * 300, deps=("abi:xrdma", "region:embed_shard"),
        digest=bytes(range(32)), seq=7, ack=5,
    )
    hop = m.HopHeader(ttl=4, root=2, pub_id=9, path=(2, 0, 3), k=2)
    return {
        "plain": m.Frame(**base),
        "flags": m.Frame(**{**base, "flags": m.FrameFlags.EXPRESS}),
        "batch": m.coalesce([
            m.Frame(**{**base, "payload": bytes([i]) * 6}) for i in range(3)
        ]),
        "hop": m.Frame(**{**base, "payload": m.pack_hop(hop) + b"xy", "flags": m.FrameFlags.HOP}),
        "am": m.Frame(kind=m.FrameKind.ACTIVE_MESSAGE, name="am", payload=b"z" * 9, seq=3),
    }


@pytest.mark.parametrize("shape", ["plain", "flags", "batch", "hop", "am"])
@pytest.mark.parametrize("direction", list(PAIRS))
def test_frames_cross_parse(direction, shape):
    src, dst = PAIRS[direction]
    frame = _frames(src)[shape]
    full = frame.pack()
    assert full == _frames(dst)[shape].pack()  # byte-identical packing
    for cached in (False, True):
        buf = frame.wire_bytes(cached)
        hdr = dst.peek_header(buf)
        assert hdr.name == frame.name and hdr.seq == frame.seq and hdr.ack == frame.ack
        assert dst.delivery_complete(buf, expect_code=not cached)
        got = dst.unpack(buf, has_code=not cached)
        assert got.payload == frame.payload and got.flags == frame.flags
        assert got.deps == (frame.deps if not cached else got.deps)
        assert dst.split_payloads(got) == src.split_payloads(frame)
        assert got.kind_breakdown(cached) == frame.kind_breakdown(cached)


@pytest.mark.parametrize("direction", list(PAIRS))
def test_hop_and_rndv_cross_parse(direction):
    src, dst = PAIRS[direction]
    hop = src.HopHeader(ttl=6, root=1, pub_id=77, path=(1, 4, 2, 0), k=3)
    packed = src.pack_hop(hop) + b"tail"
    got, off = dst.unpack_hop(packed)
    assert (got.ttl, got.root, got.pub_id, got.path, got.k) == (6, 1, 77, (1, 4, 2, 0), 3)
    assert packed[off:] == b"tail" and dst.pack_hop(got) == src.pack_hop(hop)
    desc = src.pack_rndv(3, 12345, 1 << 20)
    assert dst.unpack_rndv(desc) == (3, 12345, 1 << 20)
    assert dst.rndv_region("server1", 5) == src.rndv_region("server1", 5)


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_fat_bitcode_archives_cross_parse(direction):
    src, dst = (jax_bitcode, torch_bitcode) if direction == "jax->torch" else (
        torch_bitcode, jax_bitcode)
    fat = src.FatBitcode(slices={"cpu-host": b"\x00host", "cpu-bf2": b"bf2" * 50, "x": b""})
    data = fat.to_bytes()
    back = dst.FatBitcode.from_bytes(data)
    assert back.slices == fat.slices and back.to_bytes() == data
    for cut in (2, 5, 9, len(data) - 1):
        with pytest.raises(dst.CorruptFrame):
            dst.FatBitcode.from_bytes(data[:cut])


def test_port_archive_parses_in_jax():
    """A real port archive (torch.export slices) is a valid FBC1 archive to
    the JAX package, triple table included."""
    from repro_torch.core.xrdma import make_gather_return

    ifn = make_gather_return(max_slots=4, n_keys=2, dim=3)
    back = jax_bitcode.FatBitcode.from_bytes(ifn.code_bytes)
    assert back.triples() == ifn.fat.triples()
    assert back.digest == ifn.fat.digest


def test_slice_bytes_do_not_depend_on_the_checkout(tmp_path):
    """The same ifunc built from two copies of the package, in two processes,
    ships the same bytes: a slice names no source path, so its digest (what
    both caches key on) and its code-frame size are the tree's, not the
    checkout's."""
    from repro_torch.core.xrdma import make_gatherer

    pkg = pathlib.Path(torch_bitcode.__file__).resolve().parents[1]
    shutil.copytree(pkg, tmp_path / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    code = (
        "from repro_torch.core.xrdma import make_gatherer; "
        "print(make_gatherer(16, 2, 4, 8).fat.digest)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr
    here = make_gatherer(16, 2, 4, 8).fat
    assert out.stdout.strip() == here.digest
    for blob in here.slices.values():
        assert str(pkg).encode() not in blob


def test_wire_tables_equal():
    def profiles(m):
        return {k: dataclasses.asdict(v) for k, v in m.WIRE_PROFILES.items()}

    assert profiles(torch_transport) == profiles(jax_transport)
    assert torch_transport.TRIPLE_WIRE == jax_transport.TRIPLE_WIRE
    assert torch_transport.MEM_BW_CLASS == jax_transport.MEM_BW_CLASS
    assert torch_transport.MEM_BW_BUS == jax_transport.MEM_BW_BUS


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 1 << 20])
def test_batch_subheader_varints_equal(n):
    assert torch_frame.uvarint_encode(n) == jax_frame.uvarint_encode(n)
    pays = [bytes([i % 251]) * (i % 7) for i in range(n % 9 + 1)]
    packed = jax_frame.pack_payloads(pays)
    assert torch_frame.pack_payloads(pays) == packed
    assert torch_frame.unpack_payloads(packed) == pays
    assert np.array_equal(np.frombuffer(packed, np.uint8), np.frombuffer(
        torch_frame.pack_payloads(pays), np.uint8))
