"""Live adaptation demo: port of the JAX package's ``cli/demo.py``,
counterpart of reference ``Demo/`` (Live_Adaptation_Demo.py +
demo_model.py). A camera grabber thread (``data/grabber.py``) feeds stereo
pairs through a bounded queue into a real-time stereo thread that infers
and adapts each frame (NONE/FULL/MAD with Adam, as the demo does,
demo_model.py:163) and shows the input and the disparity with OpenCV, or
writes the disparities as 16-bit PNGs.

Run:  python -m real_time_self_adaptive_deep_stereo_torch.cli.demo \\
        --weights w.npz --blockConfig block_config/MadNet_full.json \\
        --camera folder --list pairs.csv --display none --outDir out/

Headless runs are first-class: ``--camera folder`` replays image pairs and
``--display none`` writes ``disparity_NNNNN.png`` (numbered from 1, in
frame order, as the JAX demo numbers them). The fused session (the
default) serves with the depth-1 pipeline of ``step_pipelined`` and an
fp16 disparity; ``--sessionMode host`` is the reference-style blocking
loop. The rescale to ``--imageShape`` and the crop to ``--cropShape`` run
on the session's device (the JAX demo's numpy resize on the host costs
seconds a frame at 480x640), with the same interpolation matrices. It runs
on the GPU; ``main(args, device="cpu")`` runs the plain PyTorch versions
on the CPU. The JAX demo's XLA compile cache has no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time
from typing import Optional

import numpy as np

__all__ = ["RealTimeStereo", "build_argparser", "main"]


class RealTimeStereo(threading.Thread):
    """Consumes stereo pairs from a queue; per frame: resize/crop to the
    working resolution, adaptation step, display or PNG (reference
    demo_model.py:233-284). An exception in the loop is kept in ``error``
    and ends the loop; :func:`main` raises it."""

    def __init__(
        self,
        in_queue: queue.Queue,
        session,
        image_shape=(480, 640),
        crop_shape=(320, 512),
        display: str = "cv2",
        out_dir: Optional[str] = None,
        max_frames: Optional[int] = None,
        colormap: str = "jet",
    ):
        from real_time_self_adaptive_deep_stereo_torch.utils.profiling import StepTimer

        super().__init__(daemon=True)
        self.queue = in_queue
        self.session = session
        # rescale-then-crop input stages, as the reference demo
        # (demo_model.py:80-86): image_shape is the bilinear rescale
        # target, crop_shape the centered crop; either may be None
        self.image_shape = tuple(image_shape) if image_shape else None
        self.crop_shape = tuple(crop_shape) if crop_shape else None
        self.display = display
        self.out_dir = out_dir
        self.max_frames = max_frames
        self.colormap = colormap
        self.frame_times: list = []
        self.timer = StepTimer()  # wall time between frames, the queue's wait included
        self.error: Optional[Exception] = None
        # not `_stop`, which threading.Thread uses
        self._stop_evt = threading.Event()

    def stop(self):
        self._stop_evt.set()

    def _prepare(self, item):
        """``[2, H, W, 3]`` pair -> NHWC left and right ``[1, h, w, 3]`` on
        the session's device, rescaled and cropped."""
        import torch

        from real_time_self_adaptive_deep_stereo_torch.ops.resize import crop_or_pad, resize_bilinear

        x = torch.from_numpy(np.asarray(item, np.float32)).to(self.session.engine.device)
        x = x.permute(0, 3, 1, 2)
        if self.image_shape is not None:
            x = resize_bilinear(x, *self.image_shape)
        if self.crop_shape is not None:
            x = crop_or_pad(x, *self.crop_shape)
        x = x.permute(0, 2, 3, 1).contiguous()
        return x[:1], x[1:]

    def _emit(self, disp, left, right, n):
        """Display or serialize one disparity (reference demo_model.py
        :219-225,251-258)."""
        from real_time_self_adaptive_deep_stereo_torch.utils.visual import (
            colorize_disparity,
            save_disparity_png,
        )

        if self.display == "cv2":  # pragma: no cover - needs a display
            import cv2

            vis = (colorize_disparity(disp, cmap=self.colormap) * 255).astype(np.uint8)
            vis = np.ascontiguousarray(vis[..., ::-1])
            cv2.putText(vis, f"{self.fps:5.1f} FPS  frame {n}", (8, 24), cv2.FONT_HERSHEY_SIMPLEX,
                        0.7, (255, 255, 255), 2)
            cv2.imshow("disparity", vis)
            # left and right input windows, as the reference demo (demo_model.py:219-225)
            cv2.imshow("left", left[0].cpu().numpy().astype(np.uint8)[..., ::-1])
            cv2.imshow("right", right[0].cpu().numpy().astype(np.uint8)[..., ::-1])
            cv2.waitKey(1)
        elif self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            save_disparity_png(os.path.join(self.out_dir, f"disparity_{n:05d}.png"), disp)

    def run(self):
        try:
            self._loop()
        except Exception as e:  # handed to main, which raises it
            self.error = e

    def _loop(self):
        import torch

        # The fused session serves with the depth-1 pipeline: frame i's
        # disparity is copied to the host while frame i+1 runs (one frame
        # of display staleness). The host session is the reference-style
        # blocking consumer.
        pipelined = hasattr(self.session, "step_pipelined")
        n = 0
        last_inputs = None
        while not self._stop_evt.is_set():
            try:
                item = self.queue.get(timeout=2.0)
            except queue.Empty:
                continue
            if item is None:
                break
            t0 = time.perf_counter()
            left, right = self._prepare(item)
            frame = {"left": left, "right": right}
            if pipelined:
                out = self.session.step_pipelined(frame)
                disp = None if out is None else out[0]
            else:
                frame["target"] = torch.zeros((*left.shape[:3], 1), dtype=torch.float32, device=left.device)
                disp = self.session.step(frame)["disp"][0].float().cpu().numpy()
            self.frame_times.append(time.perf_counter() - t0)
            self.timer.tick()
            n += 1
            if disp is not None:
                self._emit(disp, left, right, n - 1 if pipelined else n)
            last_inputs = (left, right)
            if self.max_frames and n >= self.max_frames:
                break
        if pipelined and last_inputs is not None:
            disp = self.session.flush_disp()  # drain the frame in flight
            if disp is not None:
                self._emit(disp[0], *last_inputs, n)

    @property
    def fps(self) -> float:
        """Steady-state throughput: mean over the last 100 frames, without
        the first 3 (the first step of each branch runs eagerly and
        captures its CUDA graph)."""
        times = self.frame_times
        if len(times) > 6:
            times = times[3:]
        if not times:
            return 0.0
        return 1.0 / np.mean(times[-100:])


def build_argparser() -> argparse.ArgumentParser:
    from real_time_self_adaptive_deep_stereo_torch.adapt.samplers import AVAILABLE_SAMPLER

    p = argparse.ArgumentParser(description="Live self-adaptive stereo demo (PyTorch/CUDA)")
    p.add_argument("--weights", required=True)
    p.add_argument("--blockConfig", required=True)
    p.add_argument("--modelName", default="MADNet")
    p.add_argument("--mode", default="MAD", choices=["NONE", "FULL", "MAD"])
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--sampleMode", default="PROBABILITY", choices=AVAILABLE_SAMPLER)
    p.add_argument(
        "--imageShape",
        type=int,
        nargs="+",
        default=[480, 640],
        help="rescale camera frames to [height,width] before cropping "
        "(reference demo default 480x640); -1 to disable",
    )
    p.add_argument(
        "--cropShape",
        type=int,
        nargs="+",
        default=[320, 512],
        help="centered crop applied after the rescale (reference demo "
        "default 320x512); -1 to disable",
    )
    p.add_argument("--SSIMTh", type=float, default=0.5)
    p.add_argument("--camera", default="folder")
    p.add_argument("--list", default=None, help="pair list for --camera folder")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--display", default="cv2", choices=["cv2", "none"])
    p.add_argument(
        "--colormap",
        default="jet",
        help="colour map of the disparity window: jet (built in, the "
        "reference demo's) or, with matplotlib, any of its names",
    )
    p.add_argument("--outDir", default=None)
    p.add_argument("--maxFrames", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--sessionMode",
        default="auto",
        choices=["auto", "fused", "host"],
        help="fused (default): on-device controller, one CUDA graph replay "
        "a frame, depth-1 pipelined fp16 disparity fetch, the lowest-latency "
        "serving mode; host: reference-style blocking per-frame consumer",
    )
    return p


def main(args, device=None) -> float:
    """Run the demo of ``args`` (``build_argparser``) on ``device``: ``cuda``
    unless ``device="cpu"``; raises where no GPU is available. Returns the
    steady frames per second."""
    import torch

    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        OnlineAdaptationSession,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.data.grabber import get_camera
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
        params_from_jax,
        params_to_jax,
        restore_or_init,
    )
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    device = resolve_device(device)
    model_kwargs = {"seed": args.seed or 0}
    if args.modelName == "MADNet":
        model_kwargs["bulkhead"] = args.mode == "MAD"
    model = get_stereo_net(args.modelName, device=device, **model_kwargs)
    # no run folder to resume from: the weights file alone
    params, restored, _ = restore_or_init("", params_to_jax(model.state_dict()), args.weights, model)
    if not restored:
        raise SystemExit(f"could not restore weights from {args.weights}")
    model.load_state_dict(params_from_jax(params))

    blocks = make_blocks(load_block_config(args.blockConfig), model)
    # the live demo adapts with Adam (reference demo_model.py:163)
    engine = AdaptationEngine(model, blocks, lr=args.lr, optimizer="adam", device=device)
    session_mode = "fused" if args.sessionMode == "auto" else args.sessionMode
    if session_mode == "fused":
        # the serving shape: the controller on the device, no ground truth
        # (a live camera has none), an fp16 disparity (half the bytes to
        # the host), fetched one frame late by RealTimeStereo
        from real_time_self_adaptive_deep_stereo_torch.adapt.fused import FusedOnlineSession

        session = FusedOnlineSession(
            engine,
            mode=args.mode,
            sample_mode=args.sampleMode,
            ssim_th=args.SSIMTh,
            seed=args.seed or 0,
            compute_metrics=False,
            disp_dtype=torch.float16,
        )
    else:
        session = OnlineAdaptationSession(
            engine,
            mode=args.mode,
            sample_mode=args.sampleMode,
            ssim_th=args.SSIMTh,
            seed=args.seed,
        )

    q: queue.Queue = queue.Queue(maxsize=1)
    cam = get_camera(args.camera, q, list_file=args.list, loop=args.loop)
    image_shape = None if args.imageShape[0] == -1 else args.imageShape
    crop_shape = None if args.cropShape[0] == -1 else args.cropShape
    worker = RealTimeStereo(
        q,
        session,
        image_shape=image_shape,
        crop_shape=crop_shape,
        display=args.display,
        out_dir=args.outDir,
        max_frames=args.maxFrames,
        colormap=args.colormap,
    )
    cam.start()
    worker.start()

    # stdin stop control (reference Live_Adaptation_Demo.py waits on
    # stdin): any input line stops the demo; end of input (a closed stdin,
    # a headless run) retires the listener without stopping
    def _stdin_stop():
        try:
            line = sys.stdin.readline()
        except Exception:
            return
        if line:
            print("stop requested from stdin")
            cam.stop()
            worker.stop()

    threading.Thread(target=_stdin_stop, daemon=True).start()
    print("demo running — press Enter to stop")
    try:
        worker.join()
    except KeyboardInterrupt:
        pass
    cam.stop()
    worker.stop()
    if worker.error is not None:
        raise worker.error
    print(f"demo done: {len(worker.frame_times)} frames, {worker.fps:.1f} FPS; "
          f"StepTimer {worker.timer.avg_ms:.2f} ms between frames, {worker.timer.fps:.1f} FPS")
    return worker.fps


if __name__ == "__main__":
    main(build_argparser().parse_args())
