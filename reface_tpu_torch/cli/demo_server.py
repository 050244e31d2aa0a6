"""Web demo: upload source + target, get the swap back (port of
reface_tpu/cli/demo_server.py).

The reference's Flask GUI (one_inference.py:443-518, templates/index.html)
as a stdlib http.server with the same POST /process_images flow: a
multipart upload of `source`, `target` and an optional `mask` (precropped
mode), answered with a PNG, or with a JSON 500 carrying the error. One lock
serialises the swaps; one torch.Generator, seeded from --seed, carries
from request to request. --safety-ckpt blurs flagged outputs.

Usage (on the card; --device cpu --tiny for a smoke run on the CPU):
  python -m reface_tpu_torch.cli.demo_server --port 7860 [--precropped]
"""

from __future__ import annotations

import argparse
import json
import threading
import traceback

import numpy as np

from reface_tpu_torch.cli.common import add_model_args, build_swapper

_PAGE = """<!doctype html>
<html><head><title>reface-tpu demo</title></head>
<body style="font-family:sans-serif;max-width:640px;margin:2em auto">
<h2>reface-tpu face swap</h2>
<form method="post" action="/process_images" enctype="multipart/form-data">
  <p>Source face: <input type="file" name="source"></p>
  <p>Target image: <input type="file" name="target"></p>
  <p>Inpaint mask (optional, white=keep): <input type="file" name="mask"></p>
  <p><button type="submit">Swap</button></p>
</form>
</body></html>"""


def _decode_multipart(body: bytes, boundary: bytes) -> dict[str, bytes]:
    parts = body.split(b"--" + boundary)
    out = {}
    for part in parts:
        if b"Content-Disposition" not in part:
            continue
        head, _, data = part.partition(b"\r\n\r\n")
        data = data.rsplit(b"\r\n", 1)[0]
        for token in head.split(b";"):
            token = token.strip()
            if token.startswith(b'name="'):
                out[token[6:-1].decode()] = data
    return out


def letterbox_frame(img, f: int):
    """Aspect-preserving resize + centre pad of an (H, W, 3) float32 image
    into an (f, f, 3) bucket (--fused: every upload one shape without
    squashing face geometry). Returns (padded, (y0, x0, nh, nw)); the box
    undoes the pad."""
    from reface_tpu_torch.io.images import resize_linear

    ih, iw = img.shape[:2]
    s = f / max(ih, iw)
    nh, nw = (max(1, int(round(ih * s))), max(1, int(round(iw * s))))
    r = resize_linear(np.ascontiguousarray(img, np.float32), nh, nw)
    pad = np.zeros((f, f, 3), np.float32)
    y0, x0 = (f - nh) // 2, (f - nw) // 2
    pad[y0:y0 + nh, x0:x0 + nw] = r
    return pad, (y0, x0, nh, nw)


def make_server(argv=None):
    """Build the configured ThreadingHTTPServer, bound and not serving (so
    that a test drives the real HTTP surface on port 0)."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_model_args(ap)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--precropped", action="store_true")
    ap.add_argument("--fused", action="store_true",
                    help="latency mode: RawSwapPipeline.swap_images_fused with "
                         "uploads letterboxed to --fused-frame")
    ap.add_argument("--fused-frame", type=int, default=1024,
                    help="frame bucket (square) for --fused uploads")
    ap.add_argument("--safety-ckpt", default=None,
                    help="StableDiffusionSafetyChecker state dict: flag/blur "
                         "NSFW outputs before returning them")
    ap.add_argument("--landmark-ckpt", default=None,
                    help="torch file of a LandmarkNet state dict")
    ap.add_argument("--landmark-rert", default=None,
                    help="native .rert ERT model: exact dlib-parity landmarks "
                         "on the host (eager mode; refused with --fused)")
    ap.add_argument("--bisenet-ckpt", default=None,
                    help="face-parser weights for the raw mode")
    args = ap.parse_args(argv)

    import torch

    from reface_tpu_torch.cli.common import (
        build_raw_pipeline,
        build_safety_checker,
        decode_keep_mask,
        default_inpaint_mask,
    )
    from reface_tpu_torch.io.images import imdecode, imencode, resize_linear
    from reface_tpu_torch.pipelines.raw import RawPipelineConfig, tiny_raw_config
    from reface_tpu_torch.pipelines.swap import clip_normalize

    swapper = build_swapper(args)
    dev = swapper.device
    raw_cfg = tiny_raw_config() if args.tiny else RawPipelineConfig()
    pipe = None if args.precropped else build_raw_pipeline(args, swapper, raw_cfg)
    safety = build_safety_checker(args.safety_ckpt, device=dev)
    lock = threading.Lock()
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    def run_swap(source: bytes, target: bytes, mask: bytes | None = None) -> bytes:
        src = imdecode(source).astype(np.float32) / 255.0
        tgt = imdecode(target).astype(np.float32) / 255.0
        with lock:
            if pipe is not None:
                # the raw mode takes its mask from the parser; an uploaded
                # mask applies only in --precropped mode
                if args.fused:
                    f = args.fused_frame
                    h, w = tgt.shape[:2]
                    tgt_in, (y0, x0, nh, nw) = letterbox_frame(tgt, f)
                    src_in, _ = letterbox_frame(src, f)
                    out01 = pipe.swap_images_fused(tgt_in[None], src_in[None],
                                                   generator=generator)[0].cpu().numpy()
                    out01 = resize_linear(
                        np.ascontiguousarray(out01[y0:y0 + nh, x0:x0 + nw]), h, w)
                else:
                    out01 = pipe.swap_images(tgt[None], src[None],
                                             generator=generator)[0].cpu().numpy()
            else:
                # pre-cropped (inference.py semantics): aligned crops and an
                # optional keep-mask, else a central face-shaped ellipse
                size = swapper.config.image_size
                tgt_r = resize_linear(tgt, size, size)
                src_r = resize_linear(src, size, size)
                keep = decode_keep_mask(mask, size) if mask else default_inpaint_mask(size)
                t = tgt_r[None] * 2 - 1
                ref = clip_normalize(torch.from_numpy(src_r[None]).to(dev)
                                     .permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                out = swapper.swap(target_image=t, inpaint_image=t * keep[None],
                                   inpaint_mask=keep[None], ref_clip224=ref,
                                   generator=generator)
                out01 = (out[0].cpu().numpy() + 1) / 2
            if safety is not None:
                filtered, flags = safety(out01[None])
                out01 = filtered[0].cpu().numpy()
                if bool(flags[0]):
                    print("[demo] safety checker flagged the output")
        return imencode(".png", np.clip(out01 * 255, 0, 255).astype(np.uint8))

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_PAGE.encode())

        def do_POST(self):
            if self.path != "/process_images":
                self.send_error(404)
                return
            ctype = self.headers.get("Content-Type", "")
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                boundary = ctype.split("boundary=")[1].encode()
                fields = _decode_multipart(body, boundary)
                png = run_swap(fields["source"], fields["target"],
                               fields.get("mask") or None)
            except Exception as e:  # the boundary: log it, report it, keep serving
                traceback.print_exc()
                self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps({"error": f"{type(e).__name__}: {e}"}).encode())
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.end_headers()
            self.wfile.write(png)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer(("0.0.0.0", args.port), Handler)


def main(argv=None):
    server = make_server(argv)
    print(f"[demo] listening on :{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
