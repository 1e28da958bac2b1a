"""The port's output path: AsyncImageSaver, MetricsLogger and the native PNG
encoder (splice_tpu_torch/utils/{io,metrics,pngio}.py), as
tests/test_concurrency.py and tests/test_native_io.py hold the
reference's.

The thread model under test (documented on each class):
- AsyncImageSaver: N producers -> bounded queue -> 1 writer thread (the
  only thread doing file IO). Drop-on-full for replaceable frames,
  blocking-enqueue for must_write artifacts, idempotent close.
- MetricsLogger: N producers -> bounded queue -> 1 writer thread (a single
  file writer, so records never interleave). Drop-on-full, idempotent
  close, no worker respawn after close.
A tensor handed to either is copied on the caller's thread (HostCopy): on
the CPU a clone, so a later write to the source does not reach the file.
"""
import io
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from splice_tpu.utils import io as jio
from splice_tpu_torch.utils import io as io_utils
from splice_tpu_torch.utils import pngio
from splice_tpu_torch.utils.metrics import HostCopy, MetricsLogger


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def test_concurrent_producers_all_must_writes_land(tmp_path,
                                                   fast_switching):
    """8 producer threads x 40 saves each, every 8th must_write with a
    unique path: every must_write artifact exists afterwards, nothing
    escapes, the worker stops."""
    saver = io_utils.AsyncImageSaver()
    img = torch.zeros((8, 8, 3))
    errors = []

    def producer(tid):
        try:
            for i in range(40):
                must = i % 8 == 0
                name = f"keep_{tid}_{i}.png" if must else f"drop_{tid}.png"
                saver.save(img, str(tmp_path / name), must_write=must)
        except Exception as e:        # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    saver.close()
    assert not errors and saver.errors == 0
    assert not any(t.is_alive() for t in threads)
    assert not saver._thread.is_alive()
    for tid in range(8):
        for i in range(0, 40, 8):
            assert (tmp_path / f"keep_{tid}_{i}.png").exists(), (tid, i)


def test_drop_discipline_under_slow_writer(tmp_path, monkeypatch):
    """With the writer slowed, save() never blocks (it drops) while
    must_write still lands."""
    real_write = io_utils._write_png

    def slow_write(arr, path, **kw):
        time.sleep(0.02)
        real_write(arr, path, **kw)

    monkeypatch.setattr(io_utils, "_write_png", slow_write)
    saver = io_utils.AsyncImageSaver()
    img = np.zeros((4, 4, 3), np.float32)
    t0 = time.perf_counter()
    for _ in range(200):                  # >> the queue's 16
        saver.save(img, str(tmp_path / "replaceable.png"))
    nonblocking_wall = time.perf_counter() - t0
    saver.save(img, str(tmp_path / "final.png"), must_write=True)
    saver.close()
    # 200 saves must not wait behind 0.02 s writes (about 4 s)
    assert nonblocking_wall < 2.0, nonblocking_wall
    assert (tmp_path / "final.png").exists()


def test_saver_copies_at_save_and_encodes_by_level(tmp_path, monkeypatch):
    """The frame is copied when save() returns (a later write to the
    tensor does not land), droppable frames at level 1, must-write at 6."""
    levels = []
    real_write = io_utils._write_png

    def record(arr, path, compress_level=6):
        levels.append(compress_level)
        real_write(arr, path, compress_level=compress_level)

    monkeypatch.setattr(io_utils, "_write_png", record)
    saver = io_utils.AsyncImageSaver()
    frame = torch.full((6, 5, 3), 7, dtype=torch.uint8)
    saver.save(frame, str(tmp_path / "a.png"))
    frame.fill_(200)
    saver.save(frame, str(tmp_path / "b.png"), must_write=True)
    saver.close()
    assert levels == [1, 6]
    assert (np.asarray(Image.open(tmp_path / "a.png")) == 7).all()
    assert (np.asarray(Image.open(tmp_path / "b.png")) == 200).all()


def test_saver_close_idempotent_and_save_after_close_noop(tmp_path):
    saver = io_utils.AsyncImageSaver()
    img = np.zeros((4, 4, 3), np.float32)
    saver.save(img, str(tmp_path / "a.png"), must_write=True)
    saver.close()
    saver.close()                         # no-op, no hang
    saver.save(img, str(tmp_path / "late.png"), must_write=True)
    assert (tmp_path / "a.png").exists()
    assert not (tmp_path / "late.png").exists()


def test_concurrent_log_async_records_never_interleave(tmp_path,
                                                       fast_switching):
    """8 threads x 60 records, tensors and numbers: every line parses
    (single writer) and carries its producer's payload intact."""
    path = tmp_path / "m.jsonl"
    logger = MetricsLogger(str(path))

    def producer(tid):
        for i in range(60):
            logger.log_async(step=tid * 1000 + i,
                             device_data={"loss": torch.tensor(float(tid)),
                                          "x": np.float32(i)},
                             host_data={"tid": tid})

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    logger.close()
    assert not any(t.is_alive() for t in threads)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines, "the queue dropped everything"
    assert logger.errors == 0
    for rec in lines:
        assert rec["loss"] == float(rec["tid"])
        assert rec["x"] == float(rec["step"] % 1000)


def test_log_async_copies_at_call_and_adds_memory_on_request(tmp_path):
    """The values are copied when log_async returns; with_memory adds the
    device memory, which is empty without CUDA in use."""
    path = tmp_path / "m.jsonl"
    logger = MetricsLogger(str(path))
    seq = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    logger.log_async(5, dict(zip(("a", "b"), seq[1])), {"lr": 0.5},
                     with_memory=True)
    seq.fill_(-1.0)
    logger.close()
    (rec,) = [json.loads(line) for line in path.read_text().splitlines()]
    assert {k: rec[k] for k in ("step", "a", "b", "lr")} == {
        "step": 5, "a": 3.0, "b": 4.0, "lr": 0.5}
    if not torch.cuda.is_initialized():
        assert not any(k.startswith("hbm_") for k in rec)


def test_close_racing_log_async_never_resurrects_worker(tmp_path):
    logger = MetricsLogger(str(tmp_path / "r.jsonl"))
    stop = threading.Event()

    def producer():
        i = 0
        while not stop.is_set():
            logger.log_async(step=i, device_data={"x": np.float32(i)})
            i += 1

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.05)
    logger.close()
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert logger._thread is None and logger._fh is None
    logger.close()                        # idempotent
    logger.log_async(step=0, device_data={"x": np.float32(0)})
    assert logger._thread is None


def test_host_copy_on_cpu_is_a_snapshot():
    t = torch.arange(6.0)
    c = HostCopy(t[2:4])
    t.zero_()
    assert c.wait().tolist() == [2.0, 3.0]


@pytest.fixture(scope="module")
def lib():
    lib = pngio.get_lib()
    if lib is None:
        pytest.skip("g++ or zlib unavailable: the encoder falls back to PIL")
    return lib


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("level", [1, 6])
def test_png_round_trip_through_pil(lib, kind, level):
    """Random pixels, and a smooth gradient (the sub/up filters)."""
    if kind == "random":
        arr = np.random.default_rng(0).integers(0, 256, (37, 53, 3),
                                                dtype=np.uint8)
    else:
        y = np.linspace(0, 255, 64)[:, None]
        x = np.linspace(0, 255, 48)[None, :]
        arr = np.stack([y + 0 * x, 0 * y + x, (y + x) / 2],
                       axis=-1).astype(np.uint8)
    data = pngio.encode_png_rgb8(arr, level)
    assert data is not None and data[:4] == b"\x89PNG"
    assert pngio.encoder() == "native (zlib)"
    back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(back, arr)


def test_png_compresses_and_declines_non_rgb8(lib):
    assert len(pngio.encode_png_rgb8(np.zeros((128, 128, 3), np.uint8))) \
        < 128 * 128 * 3 / 10
    assert pngio.encode_png_rgb8(np.zeros((8, 8), np.uint8)) is None
    assert pngio.encode_png_rgb8(np.zeros((8, 8, 4), np.uint8)) is None


def test_save_image_grayscale_falls_back_to_pil(tmp_path):
    arr = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    p = io_utils.save_image(arr, str(tmp_path / "g.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(p)), (np.clip(arr, 0, 1) * 255).astype(np.uint8))


def test_save_result_matches_reference(tmp_path):
    """save_result writes <dataroot>/out/<filename> with the reference's
    truncating quantisation, from a tensor or an array."""
    img = np.random.default_rng(3).random((6, 5, 3)).astype(np.float32)
    got = io_utils.save_result(torch.from_numpy(img), str(tmp_path / "t"))
    want = jio.save_result(img, str(tmp_path / "j"))
    assert got.endswith("out/output.png")
    np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                  np.asarray(Image.open(want)))
    np.testing.assert_array_equal(
        np.asarray(Image.open(got)),
        (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8))
