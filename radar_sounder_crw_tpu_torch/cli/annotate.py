"""Interactive annotation server: seed -> map -> refine, over JSON lines.

The TGRS-2024 workflow this framework rebuilds is user-guided: an annotator
seeds a handful of labels on one frame and the model propagates them through
the radargram (reference scripts/test/test.py; north-star target "annotator
seeds flow interactively"). The reference pays a full encoder pass per
propagate() call (reference src/utils.py:111-115); this server holds a
`PropagationPipeline` with its device-resident embedding cache, so the first
seed costs encode+propagate and every refinement (`reseed`) costs
propagation only. The port of scripts/annotate.py, same protocol.

Protocol: one JSON object per line on stdin, one JSON reply per line on
stdout (logs go to stderr). Works over a pipe or ssh; no HTTP dependency.

Commands
  {"cmd": "load", "window": 0}           stage a radargram window
  {"cmd": "seed", "seg": "gt"}           propagate from a first-frame seed
      ("gt" takes the ground-truth patch — annotator simulation; or pass a
      2-D list of int labels covering the frame's pixels); optional
      "use_last": true seeds the LAST frame and propagates backwards
  {"cmd": "reseed", "frame": 40, "seg": "gt"}   re-propagate from a new seed
      at `frame` (ORIGINAL frame order, like every other command) reusing
      cached embeddings; the frames on the propagation's upstream side keep
      the previous map — frames before `frame` in a forward session, frames
      after it in a use_last session (correction-splice semantics,
      reference scripts/test/test.py:76-85). Successive reseeds accumulate.
  {"cmd": "metrics"}                     pixel accuracy + mIoU vs ground truth
  {"cmd": "save", "path": "map.npy", "plot": "map.png"}   persist the map
  {"cmd": "info"}                        session state
  {"cmd": "quit"}

Every reply carries {"ok": true/false, "ms": <wall of the device work>}.

Run: python -m radar_sounder_crw_tpu_torch.cli.annotate --dataset 3 --model_path <encoder.pt>
(dataset registries fall back to synthetic radargrams off-host, so the
server runs anywhere; see data/registry.py).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ._common import add_device_args, load_encoder, normalize_pair


def get_args_parser():
    parser = argparse.ArgumentParser("CRW Annotate", add_help=True)
    parser.add_argument("--model", default=1, type=int, help="0=CNN,1=ResNet18")
    parser.add_argument("--dataset", default=3, type=int)
    parser.add_argument("--patch_size", default=(16, 16), nargs="+", type=int)
    parser.add_argument("--seq_length", default=100, type=int)
    parser.add_argument("--overlap", default=(8, 0), nargs="+", type=int)
    parser.add_argument("-c", "--cxt_size", default=100, type=int)
    parser.add_argument("-r", "--radius", default=10, type=int)
    parser.add_argument("-t", "--temp", default=0.1, type=float)
    parser.add_argument("-k", "--knn", default=20, type=int)
    parser.add_argument("--model_path", default="./resources/models/sharad16_3.pt")
    parser.add_argument("--pos_embed", action="store_true")
    parser.add_argument("--allow_untrained", action="store_true")
    parser.add_argument("--bn_train_mode", action="store_true",
                        help="BatchNorm batch stats at inference (the reference's de-facto behavior)")
    parser.add_argument("--xent_quirk", action="store_true",
                        help="reproduce the reference's channel-shifted xent metric")
    return add_device_args(parser)


class AnnotationSession:
    """State machine behind the JSON loop (importable for tests)."""

    def __init__(self, args):
        from ..data import create_dataset, get_reference
        from ..infer import PropagationPipeline
        from ..ops import LabelPropConfig

        self.args = args
        patch = normalize_pair(args.patch_size)
        overlap = normalize_pair(args.overlap)
        self.patch, self.overlap = patch, overlap
        model = load_encoder(
            args.model, args.pos_embed, args.model_path, args.allow_untrained, args.device
        )
        self.dataset = create_dataset(
            full=True, id=args.dataset, length=args.seq_length,
            dim=patch, overlap=overlap,
        )
        self.geo = self.dataset.geo
        self.nclasses, self.seg = get_reference(
            id=args.dataset, h=self.geo.nh * patch[0], w=0,
            length=args.seq_length, dim=patch,
        )
        self.pipe = PropagationPipeline(
            model,
            LabelPropConfig(args.cxt_size, args.radius, args.temp, args.knn),
            nclasses=self.nclasses, use_pos_embed=args.pos_embed,
            bn_train_mode=args.bn_train_mode, xent_quirk=args.xent_quirk, kernel=args.kernel,
            device=args.device,
        )
        self.window = None
        self.seq = None
        self.use_last = False
        self.pred = None  # (N, T) in ORIGINAL frame order

    # -- helpers -------------------------------------------------------------
    def _gt_patch(self, orig_frame: int) -> np.ndarray:
        """Ground-truth pixel patch covering `orig_frame` of the staged
        window (annotator simulation; the seed resize matches reference
        src/utils.py:139-147)."""
        w, ow = self.patch[1], self.overlap[1]
        x0 = self.geo.col_start(self.window) + orig_frame * (w - ow)
        return self.seg[: self.geo.rg_h(), x0 : x0 + w]

    def _seed_patch(self, spec, orig_frame: int) -> np.ndarray:
        if isinstance(spec, str):
            if spec != "gt":
                raise ValueError(f"unknown seg spec {spec!r} (use 'gt' or a 2-D list)")
            return self._gt_patch(orig_frame)
        arr = np.asarray(spec)
        if arr.ndim != 2:
            raise ValueError(f"seg must be 2-D, got shape {arr.shape}")
        return arr.astype(np.int32)

    def _counts(self, pred) -> dict:
        c = np.bincount(pred.ravel(), minlength=self.nclasses)
        return {str(i): int(n) for i, n in enumerate(c)}

    # -- commands ------------------------------------------------------------
    def cmd_load(self, p):
        i = int(p.get("window", 0))
        if not 0 <= i < len(self.dataset):
            raise ValueError(f"window {i} out of range [0, {len(self.dataset)})")
        self.seq = self.dataset[i]
        self.window = i
        self.pred = None
        T, N, H, W = self.seq.shape
        return {
            "window": i, "windows": len(self.dataset), "T": T, "N": N,
            "patch": [H, W], "nclasses": self.nclasses,
        }

    def cmd_seed(self, p):
        if self.seq is None:
            raise RuntimeError("no window staged; send 'load' first")
        self.use_last = bool(p.get("use_last", False))
        T = self.seq.shape[0]
        orig = T - 1 if self.use_last else 0
        seg_ref = self._seed_patch(p.get("seg", "gt"), orig)
        res = self.pipe(self.seq, seg_ref, use_last=self.use_last)
        pred = res.prediction[:, ::-1] if self.use_last else res.prediction
        self.pred = pred
        return {
            "change_idx": res.change_idx,
            "class_counts": self._counts(pred),
        }

    def cmd_reseed(self, p):
        if self.pred is None:
            raise RuntimeError("no previous seed; send 'seed' first")
        frame = int(p.get("frame", 0))
        T = self.seq.shape[0]
        # protocol 'frame' is in ORIGINAL frame order, like every other
        # command's output; the pipeline's cached sequence is time-flipped
        # in a use_last session, so only the reseed index flips — the seed
        # patch covers the original frame either way (use_last reverses the
        # frame ORDER, not the pixels within a frame)
        flip_f = T - 1 - frame if self.use_last else frame
        seg_ref = self._seed_patch(p.get("seg", "gt"), frame)
        res = self.pipe.reseed(seg_ref, flip_f)
        pred = res.prediction[:, ::-1] if self.use_last else res.prediction
        self.pred = pred
        return {"frame": frame, "class_counts": self._counts(pred)}

    def cmd_metrics(self, p):
        if self.pred is None:
            raise RuntimeError("no map yet; send 'seed' first")
        from ..ops.metrics import confusion_matrix, miou

        x0 = self.geo.col_start(self.window)
        gt = self.seg[: self.geo.rg_h(), x0 : x0 + self.geo.rg_len()]
        px = self.pipe.prediction_to_pixels(self.pred, gt.shape)
        cm = confusion_matrix(gt.ravel(), px.ravel(), self.nclasses)
        acc = float(np.trace(cm)) / max(1, cm.sum())
        return {"pixel_accuracy": round(acc, 4), "miou": round(miou(cm), 4)}

    def cmd_save(self, p):
        if self.pred is None:
            raise RuntimeError("no map yet; send 'seed' first")
        out = {}
        if p.get("path"):
            np.save(p["path"], self.pred)
            out["path"] = p["path"]
        if p.get("plot"):
            from ..utils.plotting import plot_segmentation

            x0 = self.geo.col_start(self.window)
            gt = self.seg[: self.geo.rg_h(), x0 : x0 + self.geo.rg_len()]
            px = self.pipe.prediction_to_pixels(self.pred, gt.shape)
            plot_segmentation(
                px, save=p["plot"], seg=gt, dataset=self.args.dataset
            )
            out["plot"] = p["plot"]
        if not out:
            raise ValueError("save needs 'path' (npy) and/or 'plot' (png)")
        return out

    def cmd_info(self, p):
        return {
            "dataset": self.args.dataset, "window": self.window,
            "windows": len(self.dataset), "seeded": self.pred is not None,
            "use_last": self.use_last, "nclasses": self.nclasses,
            "lp": {
                "cxt_size": self.args.cxt_size, "radius": self.args.radius,
                "temp": self.args.temp, "knn": self.args.knn,
            },
        }

    def handle(self, line: str) -> dict:
        try:
            p = json.loads(line)
            cmd = p.get("cmd")
            if cmd == "quit":
                return {"ok": True, "bye": True}
            fn = getattr(self, f"cmd_{cmd}", None)
            if fn is None or not isinstance(cmd, str):
                raise ValueError(f"unknown cmd {cmd!r}")
            t0 = time.perf_counter()
            out = fn(p)
            out.update(ok=True, ms=round((time.perf_counter() - t0) * 1e3, 1))
            return out
        except Exception as e:  # protocol errors must not kill the session
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def main(args):
    # stdout is RESERVED for the JSON protocol: library chatter (registry
    # fallback notices, loader warnings, matplotlib) goes to stderr
    import contextlib

    proto = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        session = AnnotationSession(args)
        print(
            json.dumps({"ok": True, "ready": True, **session.cmd_info({})}),
            file=proto, flush=True,
        )
        for line in sys.stdin:
            if not line.strip():
                continue
            reply = session.handle(line)
            print(json.dumps(reply), file=proto, flush=True)
            if reply.get("bye"):
                break


if __name__ == "__main__":
    main(get_args_parser().parse_args())
