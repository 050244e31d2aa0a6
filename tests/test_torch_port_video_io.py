"""The port's video files and video frames (reface_tpu_torch/io/video.py,
data/video.py) against cv2, which the port does not use, and the JAX
package's VideoFramesDataset, on the CPU.

- AVIs that cv2.VideoWriter writes here (FFmpeg's AVI muxer): a `png `
  stream is read bit-equal to cv2.VideoCapture's frames. An `MJPG` stream
  is read bit-equal to cv2.imdecode of each frame's chunk (libjpeg-turbo,
  the tolerance of the port's JPEG tests). cv2.VideoCapture decodes MJPEG
  through FFmpeg's own decoder and swscale, another function: on frames
  with only luma it reads within 2 levels of libjpeg here (FFmpeg's IDCT;
  held to 3), on colour frames 4-9 levels apart on average a channel
  (swscale's chroma upsampling, further from the source image than
  libjpeg's fancy upsampling). Against it the frames are held to the same
  count, fps and order (each frame nearest its own), and the luma-only
  frames to 3 levels.
- An AVI the port writes: cv2.VideoCapture reads the same frame count and
  fps, and frames held as above.
- A directory of frames, sorted; --frames-dir's PNGs; an MJPEG frame
  without Huffman tables; the forms refused without ffmpeg.
- VideoFramesDataset against the JAX dataset on the same cv2-written files:
  the same frames (lowercase .png then .jpg, sorted), keys and dtypes; the
  images within one level of 255 (resize_linear's uint8 rounding against
  cv2's, ~2/255 in [-1, 1]), the mask within 1e-5.
"""

import struct

import cv2
import numpy as np
import pytest

from test_torch_port_helpers import one_torch_thread
from test_torch_port_images import _smooth

from reface_tpu_torch.io import images as I
from reface_tpu_torch.io import video as V

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

H, W, N, FPS = 72, 104, 6, 24.0


def frames(n=N, seed=0):
    return [_smooth(H, W, seed=seed + k) for k in range(n)]


def cv2_avi(path, fourcc, imgs, fps=FPS):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (W, H))
    assert w.isOpened()
    for f in imgs:
        w.write(f[..., ::-1])
    w.release()


def capture(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f[..., ::-1])
    return out, cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)


def held_to_capture(got, ref, levels=None):
    """Same count and order (each frame nearest its own); within `levels`
    where given."""
    assert len(got) == len(ref)
    for i, a in enumerate(got):
        d = [np.abs(a.astype(int) - b).mean() for b in ref]
        assert int(np.argmin(d)) == i, d
        if levels is not None:
            assert np.abs(a.astype(int) - ref[i]).max() <= levels


def chunks(path):
    r = V.VideoReader(path)
    with open(path, "rb") as f:
        return [(f.seek(off), f.read(n))[1] for off, n in r.avi.frames]


def test_png_avi_reads_as_videocapture(tmp_path):
    imgs = frames()
    cv2_avi(tmp_path / "p.avi", "png ", imgs)
    got, fps = V.read_frames(tmp_path / "p.avi")
    ref, ref_fps, count = capture(tmp_path / "p.avi")
    assert fps == ref_fps == FPS and len(got) == len(ref) == count == N
    for a, b, c in zip(got, ref, imgs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_mjpeg_avi_reads_as_cv2_decodes(tmp_path):
    cv2_avi(tmp_path / "m.avi", "MJPG", frames())
    got, fps = V.read_frames(tmp_path / "m.avi")
    for a, data in zip(got, chunks(tmp_path / "m.avi")):
        np.testing.assert_array_equal(
            a, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
    ref, ref_fps, count = capture(tmp_path / "m.avi")
    assert fps == ref_fps and count == N
    held_to_capture(got, ref)
    assert len(V.read_frames(tmp_path / "m.avi", limit=4)[0]) == 4
    cv2_avi(tmp_path / "g.avi", "MJPG", [np.repeat(f[..., :1], 3, -1) for f in frames()])
    held_to_capture(V.read_frames(tmp_path / "g.avi")[0], capture(tmp_path / "g.avi")[0], 3)


def test_port_avi_reads_in_videocapture(tmp_path):
    imgs = frames(7, seed=10)
    out = tmp_path / "w.avi"
    with V.VideoWriter(out, 29.97, frames_dir=tmp_path / "png") as w:
        for f in imgs:
            w.write(f)
    ref, ref_fps, count = capture(out)
    got, fps = V.read_frames(out)
    assert count == len(ref) == len(got) == 7 and abs(ref_fps - 29.97) < 1e-9 and fps == ref_fps
    for a, data in zip(got, chunks(out)):
        np.testing.assert_array_equal(
            a, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
    held_to_capture(got, ref)
    pngs, _ = V.read_frames(tmp_path / "png")
    assert len(pngs) == 7 and all(np.array_equal(a, b) for a, b in zip(pngs, imgs))
    with pytest.raises(ValueError, match="frame of"):
        with V.VideoWriter(tmp_path / "x.avi", 25) as w:
            w.write(imgs[0])
            w.write(imgs[0][:8])


def test_frame_directory_and_refusals(tmp_path, monkeypatch):
    imgs = frames(3, seed=20)
    d = tmp_path / "frames"
    d.mkdir()
    I.imwrite(d / "b.png", imgs[1])
    I.imwrite(d / "a.PNG", imgs[0])
    (d / "c.jpg").write_bytes(I.imencode(".png", imgs[2]))  # read by its content
    (d / "notes.txt").write_text("not a frame")
    r = V.VideoReader(d)
    assert r.count == 3 and r.fps == 25.0
    assert all(np.array_equal(a, b) for a, b in zip(r, imgs))
    monkeypatch.setattr(V.shutil, "which", lambda name: None)
    (tmp_path / "clip.mp4").write_bytes(b"\0\0\0\x18ftypmp42" + bytes(64))
    with pytest.raises(ValueError, match="directory of PNG/JPEG frames.*MJPEG"):
        V.VideoReader(tmp_path / "clip.mp4")
    cv2_avi(tmp_path / "m.avi", "MJPG", imgs)
    data = bytearray((tmp_path / "m.avi").read_bytes())
    i = data.index(b"strf")
    data[i + 8 + 16: i + 8 + 20] = b"H264"  # the stream's compression
    j = data.index(b"vidsMJPG")
    data[j + 4: j + 8] = b"H264"
    (tmp_path / "h.avi").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="neither MJPEG nor PNG"):
        V.VideoReader(tmp_path / "h.avi")


def test_mjpeg_frame_without_huffman_tables():
    """AVI1-style MJPEG leaves out the DHT segments; the standard tables
    are put in."""
    data = I.imencode(".jpg", _smooth(40, 56, seed=5))
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2: pos + 4])[0]
        if data[pos + 1] != 0xC4:
            out += data[pos: pos + 2 + n]
        pos += 2 + n
    bare = bytes(out + data[pos:])
    assert b"\xff\xc4" not in bare
    with pytest.raises(ValueError):
        I.imdecode(bare)
    np.testing.assert_array_equal(I.imdecode(V._mjpeg_frame(bare)), I.imdecode(data))


def test_video_frames_dataset_matches_jax(tmp_path):
    from reface_tpu.data.video import VideoFramesConfig as JConfig
    from reface_tpu.data.video import VideoFramesDataset as JDataset
    from reface_tpu_torch.data import VideoFramesConfig, VideoFramesDataset

    fdir, mdir = tmp_path / "frames", tmp_path / "masks"
    fdir.mkdir()
    mdir.mkdir()
    rng = np.random.default_rng(0)
    for i, ext in enumerate([".png", ".jpg", ".png", ".jpg", ".JPG", ".jpeg"]):
        img = _smooth(90, 70, seed=30 + i)
        mask = rng.integers(0, 12, (45, 35)).astype(np.uint8)
        mask[10:30, 8:28] = 6  # skin in seg12
        cv2.imwrite(str(fdir / f"{i:04d}{ext}"), img[..., ::-1])
        cv2.imwrite(str(mdir / f"{i:04d}.png"), mask)
    jds = JDataset(JConfig(str(fdir), str(mdir), image_size=64))
    pds = VideoFramesDataset(VideoFramesConfig(str(fdir), str(mdir), image_size=64))
    assert len(pds) == len(jds) == 4 and pds.frames == jds.frames
    for i in range(len(pds)):
        got, want = pds[i], jds[i]
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got["index"] == want["index"] == i
        np.testing.assert_allclose(got["inpaint_mask"], want["inpaint_mask"], atol=1e-5, rtol=0)
        for k in ("target_image", "inpaint_image"):
            np.testing.assert_allclose(got[k], want[k], atol=2.0 / 255 + 1e-6, rtol=0)
        assert (got["inpaint_mask"] == 0).any()
