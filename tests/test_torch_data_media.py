"""The port's audio, video, Hudi and Lance datasources against the JAX
package's.

Twins of tests/test_data_media.py, run on both packages and compared
(tests/torch_twins.py): each fixture file is written once and read by
both.
"""

from __future__ import annotations

import json
import math
import os
import wave

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from torch_twins import same, start_sessions, sub


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=4, num_workers=2)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _same(pkgs, scn, want=None):
    return same(pkgs, scn, want, serve_cleanup=False)


def _data(rt):
    return sub(rt, "data")


def _sine(sr, seconds, hz, channels=1):
    t = np.arange(int(sr * seconds)) / sr
    x = np.sin(2 * math.pi * hz * t)
    return np.stack([x * (c + 1) / channels for c in range(channels)])


def _write_wav(path, amp, sr, width=2):
    inter = np.ascontiguousarray(amp.T)
    if width == 2:
        pcm = (np.clip(inter, -1, 1) * 32767).astype("<i2").tobytes()
    elif width == 1:
        pcm = ((np.clip(inter, -1, 1) * 127) + 128).astype(np.uint8).tobytes()
    else:
        raise ValueError(width)
    with wave.open(path, "wb") as w:
        w.setnchannels(amp.shape[0])
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm)


def test_read_audio_wav_stereo(pkgs, tmp_path):
    sr = 8000
    amp = _sine(sr, 0.05, 440.0, channels=2)
    p = str(tmp_path / "tone.wav")
    _write_wav(p, amp, sr)

    def scn(rt):
        rows = _data(rt).read_audio(p).take_all()
        got = rows[0]["amplitude"]
        return (len(rows), got.shape, str(got.dtype),
                int(rows[0]["sample_rate"]), got.tobytes())

    out = _same(pkgs, scn)
    assert out[:4] == (1, (2, amp.shape[1]), "float32", sr)
    got = np.frombuffer(out[4], np.float32).reshape(out[1])
    assert np.abs(got - amp).max() < 2e-4  # int16 quantization


def test_read_audio_8bit_and_aiff(pkgs, tmp_path):
    import aifc

    sr = 4000
    amp = _sine(sr, 0.03, 200.0)
    w8 = str(tmp_path / "eight.wav")
    _write_wav(w8, amp, sr, width=1)
    pa16 = str(tmp_path / "tone.aiff")
    with aifc.open(pa16, "wb") as a:
        a.setnchannels(1)
        a.setsampwidth(2)
        a.setframerate(sr)
        a.writeframes((np.clip(amp.T, -1, 1) * 32767).astype(">i2").tobytes())
    # 8-bit AIFF is SIGNED pcm (unlike WAV): silence must decode to ~0
    p8 = str(tmp_path / "quiet.aiff")
    with aifc.open(p8, "wb") as a:
        a.setnchannels(1)
        a.setsampwidth(1)
        a.setframerate(sr)
        a.writeframes(b"\x00" * 64)

    def scn(rt):
        rd = _data(rt)
        r8 = rd.read_audio(w8).take_all()[0]
        r16 = rd.read_audio(pa16).take_all()[0]
        rq = rd.read_audio(p8).take_all()[0]
        return (float(np.abs(r8["amplitude"] - amp).max()),
                int(r16["sample_rate"]),
                float(np.abs(r16["amplitude"] - amp).max()),
                float(np.abs(rq["amplitude"]).max()))

    e8, sr16, e16, quiet = _same(pkgs, scn)
    assert e8 < 2e-2 and sr16 == sr and e16 < 2e-4 and quiet == 0.0


def test_read_videos(pkgs, tmp_path):
    cv2 = pytest.importorskip("cv2")
    p = str(tmp_path / "clip.mp4")
    h, w, n = 32, 48, 12
    vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
    assert vw.isOpened()
    for i in range(n):
        vw.write(np.full((h, w, 3), i * 20 % 256, np.uint8))
    vw.release()

    def scn(rt):
        rd = _data(rt)
        rows = rd.read_videos(p).take_all()
        srows = rd.read_videos(p, frame_step=4,
                               include_timestamps=True).take_all()
        blocks = sub(rt, "data.datasource").VideoDatasource(
            [p], frames_per_block=5).read_file(p)
        return (len(rows), rows[0]["frame"].shape,
                [int(r["frame_index"]) for r in rows],
                float(rows[0]["frame"].mean()), float(rows[5]["frame"].mean()),
                [int(r["frame_index"]) for r in srows],
                "frame_timestamp" in srows[0],
                [len(b["frame_index"]) for b in blocks],
                [int(i) for i in blocks[2]["frame_index"]])

    out = _same(pkgs, scn)
    assert out[:3] == (n, (h, w, 3), list(range(n)))
    assert abs(out[3] - 0) < 15 and abs(out[4] - 100) < 15
    assert out[5:] == ([0, 4, 8], True, [5, 5, 2], [10, 11])


def _hudi_commit(root, ts, writes):
    """writes: list of (fileId, relpath)."""
    stats = [{"fileId": fid, "path": rel} for fid, rel in writes]
    os.makedirs(os.path.join(root, ".hoodie"), exist_ok=True)
    with open(os.path.join(root, ".hoodie", f"{ts}.commit"), "w") as f:
        json.dump({"partitionToWriteStats": {"": stats}}, f)


def _write_parquet(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.table(rows), path)


def test_read_hudi_snapshot_and_time_travel(pkgs, tmp_path):
    root = str(tmp_path / "tbl")
    _write_parquet(os.path.join(root, "fg1_v1.parquet"),
                   {"id": [1, 2], "v": [10, 20]})
    _write_parquet(os.path.join(root, "fg2_v1.parquet"),
                   {"id": [3, 4], "v": [30, 40]})
    _hudi_commit(root, "001", [("fg1", "fg1_v1.parquet"),
                               ("fg2", "fg2_v1.parquet")])
    _write_parquet(os.path.join(root, "fg1_v2.parquet"),
                   {"id": [1, 2], "v": [11, 21]})
    _hudi_commit(root, "002", [("fg1", "fg1_v2.parquet")])
    open(os.path.join(root, ".hoodie", "003.commit.inflight"), "w").close()

    def scn(rt):
        rd = _data(rt)

        def pairs(ds):
            return [(int(r["id"]), int(r["v"])) for r in
                    sorted(ds.take_all(), key=lambda r: r["id"])]

        proj = rd.read_hudi(root, columns=["v"], filter=[("v", ">", 25)])
        rows = proj.take_all()
        return (pairs(rd.read_hudi(root)), pairs(rd.read_hudi(root,
                                                              as_of="001")),
                sorted(int(r["v"]) for r in rows),
                all(set(r) == {"v"} for r in rows))

    _same(pkgs, scn, ([(1, 11), (2, 21), (3, 30), (4, 40)],
                      [(1, 10), (2, 20), (3, 30), (4, 40)], [30, 40], True))


def test_read_hudi_replacecommit_drops_replaced_groups(pkgs, tmp_path):
    root = str(tmp_path / "tbl")
    _write_parquet(os.path.join(root, "fg1.parquet"), {"id": [1], "v": [10]})
    _write_parquet(os.path.join(root, "fg2.parquet"), {"id": [2], "v": [20]})
    _hudi_commit(root, "001", [("fg1", "fg1.parquet"),
                               ("fg2", "fg2.parquet")])
    _write_parquet(os.path.join(root, "fg3.parquet"),
                   {"id": [1, 2], "v": [10, 20]})
    meta = {"partitionToWriteStats": {"": [{"fileId": "fg3",
                                            "path": "fg3.parquet"}]},
            "partitionToReplaceFileIds": {"": ["fg1", "fg2"]}}
    with open(os.path.join(root, ".hoodie", "002.replacecommit"), "w") as f:
        json.dump(meta, f)

    def scn(rt):
        rows = sorted(_data(rt).read_hudi(root).take_all(),
                      key=lambda r: r["id"])
        return [(int(r["id"]), int(r["v"])) for r in rows]

    _same(pkgs, scn, [(1, 10), (2, 20)])


def test_read_hudi_not_a_table(pkgs, tmp_path):
    def scn(rt):
        with pytest.raises(FileNotFoundError, match="hoodie") as ei:
            _data(rt).read_hudi(str(tmp_path / "nope")).take_all()
        return str(ei.value)

    _same(pkgs, scn)


def test_read_lance_gated(pkgs):
    """With pylance absent the connector fails with a clear import error
    at construction, not deep inside a read task."""
    try:
        import lance  # noqa: F401
        pytest.skip("lance installed: gate not exercised")
    except ImportError:
        pass

    def scn(rt):
        with pytest.raises(ImportError, match="lance") as ei:
            _data(rt).read_lance("/tmp/whatever")
        return str(ei.value)

    _same(pkgs, scn)
