"""Raw-image swap: detect and align -> parse -> swap -> paste back (port of
reface_tpu/pipelines/raw.py).

Target and source frames are aligned to align_size^2 by the FFHQ quad of
their 68 landmarks, BiSeNet's seg12 map of each crop gives the face mask
(the target's region to inpaint, the source's preserved face for the CLIP
reference), the pre-cropped swap (pipelines/swap.py) runs on the crop at
the swap's resolution with the landmarks re-detected on that crop (the
conditioning vector is in crop coordinates), and the result is warped back
onto the frame by the inverse homography. Multi-face: the face classes of
the frame's parsing map are split into connected components on the host,
every face swaps in one batch, and the swaps are composited in turn.

Landmarks come from LandmarkNet on the device, or from a host
`landmark_fn` (the exact ERT, nn/landmarks.py:landmark68_fn_from_rert).
The JAX package compiles `swap_images_fused` and `swap_images_robust(
one_program=True)` into one XLA program each; here both run the same ops
eagerly and keep the results of those programs: a traced program cannot
call the host, so there every landmark (swap_images_fused), or the
conditioning re-detect alone (one_program=True), comes from LandmarkNet.

Public methods take and return NHWC images in [0,1], as the JAX API does;
inside, images are NCHW. The pipeline runs on its swapper's device: CUDA
unless device="cpu" is passed; it never drops to the CPU by itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reface_tpu_torch.nn.bisenet import BiSeNet, BiSeNetConfig, parse_faces
from reface_tpu_torch.nn.landmarks import LandmarkNet, LandmarkNetConfig
from reface_tpu_torch.ops.resize import resize_bilinear_aa, resize_bilinear_no_aa, resize_nearest
from reface_tpu_torch.pipelines.swap import FaceSwapper, clip_normalize, init_params, resolve_device
from reface_tpu_torch.preprocess.align import compute_align_quad, paste_back, quad_crop
from reface_tpu_torch.preprocess.masks import FACE_PARSING_TO_SEG12

__all__ = ["DEFAULT_SEG12_FACE", "RawPipelineConfig", "RawSwapPipeline", "tiny_raw_config"]

# seg12 classes treated as "face" for target removal and source preservation
# (lip, eyebrows, eyes, nose, skin, ears, mouth)
DEFAULT_SEG12_FACE = (1, 2, 3, 5, 6, 7, 9)


@dataclasses.dataclass(frozen=True)
class RawPipelineConfig:
    align_size: int = 1024
    parse_size: int = 512
    seg12_face_classes: tuple = DEFAULT_SEG12_FACE
    landmark: LandmarkNetConfig = LandmarkNetConfig()
    bisenet: BiSeNetConfig = BiSeNetConfig()


def tiny_raw_config(seg12_face_classes: tuple = DEFAULT_SEG12_FACE) -> RawPipelineConfig:
    """The smoke-size raw config paired with tiny_swap_config: 64 px align
    and parse, a narrow LandmarkNet at 64 px, fp32 throughout."""
    return RawPipelineConfig(
        align_size=64,
        parse_size=64,
        seg12_face_classes=seg12_face_classes,
        landmark=LandmarkNetConfig(widths=(8, 16, 32, 32), input_size=64,
                                   dtype=torch.float32),
        bisenet=BiSeNetConfig(dtype=torch.float32),
    )


def _tensor(x, device) -> torch.Tensor:
    """An array or tensor as an fp32 tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, device=device).float()


def _nchw(x, device) -> torch.Tensor:
    """(B, H, W, C) array or tensor -> (B, C, H, W) fp32 on `device`."""
    return _tensor(x, device).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class RawSwapPipeline:
    """A FaceSwapper with detection, alignment, parsing and paste-back."""

    def __init__(self, swapper: FaceSwapper, config: RawPipelineConfig = RawPipelineConfig(),
                 landmark_params: dict | None = None, bisenet_params: dict | None = None,
                 seed: int = 0, landmark_fn=None, device=None):
        """landmark_params / bisenet_params: the port's LandmarkNet and
        BiSeNet state dicts (bisenet_params keyed as the face-parsing
        checkpoint); None gives a seeded random init (init_params, `seed`).

        landmark_fn: an optional HOST landmark source in place of
        LandmarkNet: (B, H, W, 3) [0,1] tensor -> (B, 68, 2) pixel
        coordinates at input scale (numpy or tensor), e.g.
        landmark68_fn_from_rert(path) for exact ERT landmarks.

        device: the device of the pipeline, which must be its swapper's
        (CUDA when None; raises without a card)."""
        self.device = resolve_device(device)
        if self.device.type != swapper.device.type:
            raise ValueError(f"the pipeline's device {self.device} is not its "
                             f"swapper's ({swapper.device})")
        self.swapper = swapper
        self.config = config
        self.landmark_fn = landmark_fn
        self.landmark_net = LandmarkNet(config.landmark, device=self.device)
        self.bisenet = BiSeNet(config.bisenet, device=self.device)
        for net, params in ((self.landmark_net, landmark_params),
                            (self.bisenet, bisenet_params)):
            if params is None:
                init_params(net, seed=seed)
            else:
                net.load_state_dict(params)
            net.eval().requires_grad_(False)
        lut = np.zeros(12, np.float32)
        lut[list(config.seg12_face_classes)] = 1.0
        self._face_lut = torch.as_tensor(lut, device=self.device)

    # ---- stages (NCHW inside) ----

    def _landmarks(self, x: torch.Tensor, host: bool = True) -> torch.Tensor:
        """(B, 3, H, W) [0,1] -> (B, 68, 2) pixel coordinates at input scale:
        the host landmark_fn when there is one and `host`, else LandmarkNet."""
        if host and self.landmark_fn is not None:
            lm = self.landmark_fn(_nhwc(x))
            lm = lm.cpu() if isinstance(lm, torch.Tensor) else lm
            return torch.as_tensor(np.asarray(lm, np.float32), device=self.device)
        s = self.config.landmark.input_size
        b, _, h, w = x.shape
        lm = self.landmark_net(resize_bilinear_aa(x, s, s) * 2 - 1)
        return lm.reshape(b, 68, 2) * torch.tensor([w / s, h / s], device=x.device)

    def _align(self, x: torch.Tensor, lm68: torch.Tensor):
        """Crop each image to align_size^2 by its FFHQ quad: (crops, quads)."""
        quads = compute_align_quad(lm68)
        return quad_crop(x, quads, self.config.align_size), quads

    def _parse(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) [0,1] -> (B, H, W) int32 seg12 map: BiSeNet at
        parse_size, the classes resized back by nearest."""
        b, _, h, w = x.shape
        p = self.config.parse_size
        seg = parse_faces(self.bisenet, resize_bilinear_aa(x, p, p),
                          remap_lut=FACE_PARSING_TO_SEG12)
        return resize_nearest(seg[:, None], h, w)[:, 0]

    def _face_mask(self, seg12: torch.Tensor) -> torch.Tensor:
        """(B, H, W) seg12 -> (B, 1, H, W) float, 1 on the face classes."""
        return self._face_lut[seg12.long()][:, None]

    # ---- stages, the JAX package's NHWC API ----

    @torch.inference_mode()
    def detect_landmarks(self, image01) -> torch.Tensor:
        """(B, H, W, 3) in [0,1] -> (B, 68, 2) pixel coordinates at input scale."""
        return self._landmarks(_nchw(image01, self.device))

    @torch.inference_mode()
    def align(self, image01, lm68):
        """(B, H, W, 3) frames and (B, 68, 2) landmarks -> ((B, A, A, 3)
        crops, (B, 4, 2) quads)."""
        crops, quads = self._align(_nchw(image01, self.device), _tensor(lm68, self.device))
        return _nhwc(crops), quads

    @torch.inference_mode()
    def parse(self, crops01) -> torch.Tensor:
        """(B, S, S, 3) in [0,1] -> (B, S, S) int32 seg12 class map."""
        return self._parse(_nchw(crops01, self.device))

    def face_mask(self, seg12) -> torch.Tensor:
        """(B, S, S) seg12 -> (B, S, S, 1) float face mask."""
        return self._face_mask(torch.as_tensor(seg12, device=self.device)).permute(0, 2, 3, 1)

    # ---- the shared swap body ----

    def _swap_crops(self, t_crop, t_face, ref224, generator, host: bool):
        """Swap aligned (B, 3, A, A) crops with their (B, 1, A, A) face masks
        at the swapper's resolution; returns (B, 3, A, A) in [0,1]. The
        conditioning landmarks are re-detected on the swap-resolution crop,
        in crop coordinates."""
        size = self.swapper.config.image_size
        b = t_crop.shape[0]
        t_small = resize_bilinear_aa(t_crop, size, size)
        t_mask = 1.0 - resize_bilinear_aa(t_face, size, size)
        target_pm1 = t_small * 2 - 1
        out = self.swapper.swap(
            target_image=_nhwc(target_pm1),
            inpaint_image=_nhwc(target_pm1 * t_mask),
            inpaint_mask=_nhwc(t_mask),
            ref_clip224=ref224,
            landmarks=self._landmarks(t_small, host).reshape(b, 136),
            generator=generator,
        )
        out01 = (out.permute(0, 3, 1, 2) + 1.0) / 2.0
        a = self.config.align_size
        return resize_bilinear_no_aa(out01, a, a)

    def _swap_aligned(self, t_crop, ref224, generator, host: bool = True):
        """Parse, mask and swap aligned (B, 3, A, A) crops against
        (B, 224, 224, 3) CLIP references; (B, 3, A, A) in [0,1]."""
        return self._swap_crops(t_crop, self._face_mask(self._parse(t_crop)), ref224,
                                generator, host)

    @torch.inference_mode()
    def _source_reference(self, source01, host: bool = True) -> torch.Tensor:
        """Align and parse (B, h, w, 3) sources; returns their CLIP-normalized
        masked references, (B, 224, 224, 3)."""
        src = _nchw(source01, self.device)
        s_crop, _ = self._align(src, self._landmarks(src, host))
        return _nhwc(clip_normalize(s_crop * self._face_mask(self._parse(s_crop))))

    # ---- end to end ----

    def _swap_images(self, target01, source01, generator, host: bool):
        tgt = _nchw(target01, self.device)
        t_crop, t_quads = self._align(tgt, self._landmarks(tgt, host))
        ref224 = self._source_reference(source01, host)
        out_big = self._swap_aligned(t_crop, ref224, generator, host)
        return _nhwc(paste_back(tgt, out_big, t_quads))

    @torch.inference_mode()
    def swap_images(self, target01, source01, generator: torch.Generator | None = None):
        """Full raw swap, one face per frame: (B, H, W, 3) targets and
        (B, h, w, 3) sources in [0,1] -> the composited (B, H, W, 3) frames.
        `generator` (on the pipeline's device) draws the swap's noise."""
        return self._swap_images(target01, source01, generator, host=True)

    @torch.inference_mode()
    def swap_images_fused(self, target01, source01,
                          generator: torch.Generator | None = None):
        """`swap_images` with the JAX package's one-program semantics: every
        landmark from LandmarkNet, also with a host landmark_fn (the JAX
        program cannot call the host). Runs eagerly, as swap_images."""
        return self._swap_images(target01, source01, generator, host=False)

    @torch.inference_mode()
    def face_presence(self, target01, min_area_frac: float = 2e-3) -> torch.Tensor:
        """(B, H, W, 3) -> (B,) bool: does the frame hold a face region of at
        least min_area_frac of its area? (The parsing mask stands in for
        dlib's "no detection" signal.)"""
        p = self.config.parse_size
        x = resize_bilinear_aa(_nchw(target01, self.device), p, p)
        seg = parse_faces(self.bisenet, x, remap_lut=FACE_PARSING_TO_SEG12)
        return self._face_mask(seg)[:, 0].mean(dim=(1, 2)) >= min_area_frac

    @torch.inference_mode()
    def swap_images_robust(self, target01, source01,
                           generator: torch.Generator | None = None, state=None,
                           min_area_frac: float = 2e-3, one_program: bool = True,
                           ref224=None):
        """swap_images with the last-good-frame fallback: a frame without a
        face (face_presence) is swapped as the last frame that had one, with
        its landmarks, so its output repeats that frame's swap; frames before
        any detection pass through unswapped.

        one_program=True keeps the JAX one-program semantics: the alignment
        landmarks and the source reference come from the host landmark_fn
        when there is one, the 512 px conditioning re-detect from
        LandmarkNet. one_program=False takes every landmark from the host
        function when there is one. Both run eagerly.

        ref224: an optional precomputed `_source_reference(source01)`, for a
        source that stays the same across batches.

        Returns (frames (B, H, W, 3), new_state, quads (B, 4, 2) numpy).
        Thread `state` through the batches of one video: opaque, None until
        a face has been seen."""
        tgt = _nchw(target01, self.device)
        present = torch.as_tensor(self.face_presence(target01, min_area_frac)).tolist()
        lm = self._landmarks(tgt)
        last = state
        frames, lms, passthrough = [], [], []
        for i, p in enumerate(present):
            if p:
                last = (tgt[i], lm[i])
            if last is None:
                passthrough.append(i)
                frames.append(tgt[i])
                lms.append(lm[i])
            else:
                frames.append(last[0])
                lms.append(last[1])
        if last is not None and last is not state:
            # the state outlives this batch's tensors, which may be the caller's
            last = (last[0].clone(), last[1].clone())
        f_eff = torch.stack(frames)
        t_crop, t_quads = self._align(f_eff, torch.stack(lms))
        if ref224 is None:
            ref224 = self._source_reference(source01)
        ref224 = _tensor(ref224, self.device)
        out = paste_back(f_eff, self._swap_aligned(t_crop, ref224, generator,
                                                   host=not one_program), t_quads)
        out[passthrough] = tgt[passthrough]
        return _nhwc(out), last, t_quads.cpu().numpy()

    # ---- multi-face ----

    @torch.inference_mode()
    def detect_faces(self, frame01, max_faces: int = 4, min_area_frac: float = 2e-3):
        """Host-side multi-face detection on ONE (H, W, 3) frame: parse the
        frame, split the face classes into 8-connected components, return
        up to max_faces [x0, y0, x1, y1] boxes (end exclusive), largest
        first, the order of the JAX package's cv2 labelling among equals."""
        from scipy import ndimage

        frame = _tensor(frame01, self.device)
        h, w = frame.shape[:2]
        seg = self._parse(frame.permute(2, 0, 1)[None])
        face = (self._face_mask(seg)[0, 0] > 0.5).cpu().numpy()
        labels, num = ndimage.label(face, structure=np.ones((3, 3), bool))
        areas = np.bincount(labels.ravel(), minlength=num + 1)
        # cv2.connectedComponentsWithStats (8-connected) labels components in
        # the order its scan of 2x2 blocks first meets them; equal areas keep it
        ys, xs = np.indices(face.shape)
        block = (ys // 2) * (w // 2 + 1) + xs // 2
        first = ndimage.minimum(block, labels, np.arange(1, num + 1)) if num else []
        boxes = []
        for i, (sy, sx) in enumerate(ndimage.find_objects(labels), start=1):
            if areas[i] >= min_area_frac * h * w:
                boxes.append((-int(areas[i]), first[i - 1], (sx.start, sy.start, sx.stop, sy.stop)))
        boxes.sort(key=lambda t: t[:2])
        return [b for _, _, b in boxes[:max_faces]]

    @torch.inference_mode()
    def landmarks_in_box(self, frame01, box) -> torch.Tensor:
        """68 landmarks of the face inside `box`, (68, 2) in FRAME pixel
        coordinates. The box is padded to a square crop (truncated to whole
        pixels), resized bilinearly without antialias to the LandmarkNet
        input, and its landmarks mapped back."""
        frame = _tensor(frame01, self.device)
        h, w = frame.shape[:2]
        x0, y0, x1, y1 = box
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        half = max(x1 - x0, y1 - y0) * 0.75
        sx0, sy0 = int(max(0, cx - half)), int(max(0, cy - half))
        sx1, sy1 = int(min(w, cx + half)), int(min(h, cy + half))
        s = self.config.landmark.input_size
        crop = frame[sy0:sy1, sx0:sx1].permute(2, 0, 1)[None]
        lm = self._landmarks(resize_bilinear_no_aa(crop, s, s))[0]
        scale = torch.tensor([(sx1 - sx0) / s, (sy1 - sy0) / s], device=self.device)
        return lm * scale + torch.tensor([sx0, sy0], dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def swap_frame_multiface(self, frame01, source01,
                             generator: torch.Generator | None = None, max_faces: int = 4):
        """Swap EVERY detected face of one (H, W, 3) frame with the same
        (1, h, w, 3) source: all faces in one batch, composited in turn."""
        frame = _tensor(frame01, self.device)
        boxes = self.detect_faces(frame, max_faces=max_faces)
        if not boxes:
            return frame
        lm68 = torch.stack([self.landmarks_in_box(frame, b) for b in boxes])
        f = len(boxes)
        x = frame.permute(2, 0, 1)[None]
        t_crop, t_quads = self._align(x.expand(f, -1, -1, -1), lm68)
        ref224 = self._source_reference(source01)[:1].expand(f, -1, -1, -1)
        out_big = self._swap_aligned(t_crop, ref224, generator)
        for i in range(f):
            x = paste_back(x, out_big[i:i + 1], t_quads[i:i + 1])
        return x[0].permute(1, 2, 0).contiguous()
