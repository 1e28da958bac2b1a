"""Video appearance transfer (port of splice_tpu/video.py): each frame is
optimised in turn, every frame after the first warm-started from the
previous frame's final parameters with a fresh optimizer state.

<dataroot>/A holds the frames in name order, <dataroot>/B the appearance
image. Frames of one geometry share one program: on CUDA the graphs
captured for the first frame replay for every later one (its trainer
restarts in place: SpliceTrainer.restart). A frame of another geometry
builds a new program, as the reference does.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from splice_tpu_torch import resolve_device, trainer
from splice_tpu_torch.config import Config
from splice_tpu_torch.data import load_video_frames
from splice_tpu_torch.utils.io import AsyncImageSaver
from splice_tpu_torch.utils.metrics import MetricsLogger


def _prefetch(it: Iterable, depth: int = 1) -> Iterator:
    """Iterate `it` one item ahead on a thread (the next frame's decode
    beside this frame's optimisation); whatever the thread raises, an
    exit or an interrupt too, is raised here (else the consumer would wait
    on the queue forever). The thread touches only the host."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(end)
        except BaseException as e:   # handed to the consumer, raised there
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def train_video(cfg: Config, first_frame_steps: Optional[int] = None,
                warm_frame_steps: Optional[int] = None, device=None,
                on_frame: Optional[Callable[[int, Dict[str, Any]], None]]
                = None) -> Dict[str, Any]:
    """Optimise each frame in turn on `device` (default cfg.device, i.e.
    CUDA): the first for first_frame_steps (default cfg.n_epochs), the
    others for warm_frame_steps (default max(n_epochs // 10, 1)), each
    from the previous frame's final flat parameters. One AsyncImageSaver
    and one MetricsLogger serve the clip; each frame's output goes to
    <dataroot>/out/<frame stem>_out.png (must-write). With
    cfg.video_log_frames_only a warm frame renders and logs at its end
    only. on_frame(index, train_pair's result) follows each frame.
    Returns each frame's stats and the final flat parameters."""
    dev = resolve_device(device if device is not None else cfg.device)
    first_steps = (first_frame_steps if first_frame_steps is not None
                   else cfg.n_epochs)
    warm_steps = (warm_frame_steps if warm_frame_steps is not None
                  else max(cfg.n_epochs // 10, 1))
    extractor = trainer.make_extractor_from_config(cfg, dev)
    out_dir = os.path.join(cfg.dataroot, "out")
    flat, program, stats = None, None, []
    saver = AsyncImageSaver()
    logger = MetricsLogger(cfg.metrics_path
                           or os.path.join(out_dir, "metrics.jsonl"))
    try:
        frames = _prefetch(load_video_frames(cfg, device=dev))
        for idx, (name, host_pair) in enumerate(frames):
            pair = host_pair.to(dev)
            steps = first_steps if idx == 0 else warm_steps
            if (program is not None
                    and program.trainer.pair.geometry != pair.geometry):
                program = None
            fcfg = cfg
            if idx > 0 and cfg.video_log_frames_only:
                fcfg = dataclasses.replace(
                    cfg, log_images_freq=max(cfg.log_images_freq, steps))
            res = trainer.train_pair(fcfg, n_steps=steps, device=dev,
                                     pair=pair, extractor=extractor,
                                     init_params=flat, program=program,
                                     saver=saver, logger=logger,
                                     want_output=False)
            flat, program = res["flat"], res["program"]
            stem = os.path.splitext(name)[0]
            saver.save(res["output_u8"],
                       os.path.join(out_dir, f"{stem}_out.png"),
                       must_write=True)
            last = res["losses"][-1] if res["losses"] else {}
            stats.append({"frame": name, "steps": steps,
                          "steps_per_sec": res["steps_per_sec"],
                          "loss": last.get("loss")})
            print(f"[video] frame {idx} ({name}): {steps} steps, "
                  f"{res['steps_per_sec']:.2f} steps/s")
            if on_frame is not None:
                on_frame(idx, res)
    finally:
        saver.close()
        logger.close()
    return {"frames": stats, "params": flat}
