"""Depth datasets: `.npy` frames and their labels on the host, the network's
input images and GT targets made on the device.

The port's counterpart of `popnet_tpu/data/datasets.py`:

- `prepare_batch` warps a batch of frames through per-frame augmentation
  maps (`augment_device.warp_depth_batch`), clips, normalizes, resizes the
  clipped depth to the z-grid and encodes every GT target
  (`ops.encoders.encode_targets`), all on the device;
- `KDH3DDataset` (training): `get_batch_host` loads frames (with `bg_aug`,
  composited over a background on the host), draws each frame's
  augmentation from the dataset's `np.random.Generator` in the JAX
  package's order and moves its labels; `to_device` copies the images
  (float32 metres or, with `transfer="u16mm"`, uint16 millimetres cast on
  the device) and the label arrays to the device and runs `prepare_batch`; `iter_batches` runs the two stages on threads ahead of
  the consumer (`_pipeline_iter`), so host assembly overlaps the card;
- `MPRealDataset` (evaluation): one float32 copy, the warp of a plain
  resize, clip and normalize; no targets.

One seed gives the images of the JAX package's `get_batch` bit for bit
(the warp rounds as XLA does) and its targets within the encoders' bars.
The mp-aug datasets (`KDH3DMPAugDataset`, `DeviceMPAugDataset`, the
streaming bank) wait for ROADMAP Queue 1 item 10b.
"""

from __future__ import annotations

import json
import os
import queue
import random as _pyrandom
import threading

import numpy as np
import torch

from popnet_tpu_torch.core.config import KDH3D_DATASET, DatasetConfig, EncoderConfig
from popnet_tpu_torch.core.device import resolve_device
from popnet_tpu_torch.core.numerics import div_const
from popnet_tpu_torch.core.skeleton import SWAP_INDICES
from popnet_tpu_torch.data import augment_device as ad
from popnet_tpu_torch.data.labels import OOB, load_label_file, pack_annotations
from popnet_tpu_torch.ops.encoders import encode_targets
from popnet_tpu_torch.ops.resize import resize_bilinear_cv2


def prepare_batch(images, inv_mats, depth_scales, flips, joints2d, joints3d, bboxes,
                  pose_weights, valid, ecfg: EncoderConfig, dcfg: DatasetConfig,
                  pose_align: bool = True, with_prior: bool = True) -> dict:
    """Warp, clip, normalize and GT-encode a batch on its device: images
    (B, H, W) float32 metres, inv_mats (B, 2, 3), depth_scales (B,), flips
    (B,) bool and the labels already moved by the augmentation (joints2d
    (B, P, K, 2), joints3d (B, P, K, 3), bboxes (B, P, 4), pose_weights
    (B, P), valid (B, P) bool) -> {"image": (B, input_y, input_x, 1), the
    targets of `encode_targets`}."""
    warped = ad.warp_depth_batch(images, inv_mats, ecfg.input_y, ecfg.input_x,
                                 depth_scales=depth_scales, flips=flips)
    clipped = warped.clamp(0.0, dcfg.depth.max)
    out = {"image": div_const(clipped - dcfg.depth.mean, dcfg.depth.std)[..., None]}
    depth_resize = resize_bilinear_cv2(clipped, ecfg.zgrid_h, ecfg.zgrid_w)
    out.update(encode_targets(joints2d, joints3d, bboxes, pose_weights, valid, depth_resize,
                              ecfg, dcfg.depth, pose_align=pose_align, with_prior=with_prior))
    return out


_STOP = object()  # pipeline end-of-stream sentinel
PREFETCH = 2      # batches each stage of iter_batches' pipeline runs ahead


def _pipeline_iter(source, stages, depth: int):
    """Run `source` items through `stages` (1-arg functions), one thread a
    stage with bounded queues of `depth`; yields the results in order. An
    error in any stage reaches the consumer; abandoning the generator
    unwinds every stage."""
    qs = [queue.Queue(maxsize=max(1, depth)) for _ in range(len(stages) + 1)]
    abandoned = threading.Event()
    errs: list[Exception] = []

    def _put(q, item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def feeder():
        try:
            for item in source:
                if abandoned.is_set() or not _put(qs[0], item):
                    return
        except Exception as e:
            errs.append(e)
        finally:
            _put(qs[0], _STOP)

    def worker(i, fn):
        try:
            while True:
                item = qs[i].get()
                if item is _STOP or abandoned.is_set():
                    return
                if not _put(qs[i + 1], fn(item)):
                    return
        except Exception as e:
            errs.append(e)
        finally:
            _put(qs[i + 1], _STOP)

    threads = [threading.Thread(target=feeder, daemon=True)] + [
        threading.Thread(target=worker, args=(i, fn), daemon=True)
        for i, fn in enumerate(stages)]
    for t in threads:
        t.start()
    try:
        while True:
            item = qs[-1].get()
            if item is _STOP:
                break
            yield item
    finally:
        abandoned.set()
        for t in threads:
            t.join(timeout=5.0)
    if errs:
        raise errs[0]


class KDH3DDataset:
    """Single-person KDH3D frames for training, optionally composited over
    backgrounds (`bg_aug`): `get_batch(indices)` returns the device batch of
    `prepare_batch`. With `augment` each frame draws a random rotation,
    render scale and crop (no flip: the flipped, mirrored-label augmentation
    waits for the mp-aug datasets, ROADMAP Queue 1 item 10b); without it, the
    plain resize (one draw of the generator a frame, as in the JAX package)."""

    def __init__(self, img_dir: str, ann_file: str, bg_aug: bool = False,
                 bg_file: str | None = None, bg_dir: str | None = None,
                 seg_dir: str | None = None, ecfg: EncoderConfig = EncoderConfig(),
                 dcfg: DatasetConfig = KDH3D_DATASET, pose_align: bool = True,
                 with_prior: bool = True, augment: bool = True,
                 seed: int = 0, transfer: str = "f32",
                 cache_images: bool = False, device: str | torch.device = "cuda"):
        if transfer not in ("f32", "u16mm"):
            raise ValueError(f"transfer must be 'f32' or 'u16mm', got {transfer!r}")
        self.device = resolve_device(device)
        self.img_dir = img_dir
        self.anno_dic, self.intrinsics = load_label_file(ann_file)
        self.ids = list(self.anno_dic.keys())
        self.ecfg, self.dcfg = ecfg, dcfg
        self.pose_align, self.with_prior = pose_align, with_prior
        self.augment = augment
        self.transfer = transfer
        # decoded frames kept in host RAM across epochs (~1 MB a 512x480
        # frame); read-only by convention, every consumer derives new arrays
        self.cache_images = cache_images
        self._npy_cache: dict[str, np.ndarray] = {}
        self.rng = np.random.default_rng(seed)
        self.bg_aug = bg_aug
        if bg_aug:
            with open(bg_file) as f:
                self.bg_list = list(json.load(f).values())
            _pyrandom.Random(seed).shuffle(self.bg_list)
            self.bg_dir, self.seg_dir = bg_dir, seg_dir

    def __len__(self):
        return len(self.ids)

    def _load_npy(self, path: str) -> np.ndarray:
        if not self.cache_images:
            return np.load(path).astype(np.float32)
        arr = self._npy_cache.get(path)
        if arr is None:
            arr = np.load(path).astype(np.float32)
            arr.setflags(write=False)
            self._npy_cache[path] = arr
        return arr

    def load_composited(self, index: int):
        """(depth (H, W) float32 metres, the frame's annotation list); with
        bg_aug, depth * fg + bg * (1 - fg) over background index % n_bg."""
        image_id = self.ids[index]
        depth = self._load_npy(os.path.join(self.img_dir, image_id))
        if self.bg_aug:
            entry = self.bg_list[index % len(self.bg_list)]
            bg = self._load_npy(os.path.join(self.bg_dir, entry["file_name"]))
            fg = self._load_npy(os.path.join(self.seg_dir, image_id))
            depth = depth * fg + bg * (1.0 - fg)
        return depth, list(self.anno_dic[image_id])

    def _params(self, h: int, w: int) -> ad.AffineParams:
        iy, ix = self.ecfg.input_y, self.ecfg.input_x
        if self.augment:
            return ad.sample_augment_params(self.rng, h, w, iy, ix, rotate_deg=10.0,
                                            render_min=0.7, render_max=1.2,
                                            max_crop=0.1)
        return ad.sample_augment_params(self.rng, h, w, iy, ix, rotate_deg=0.0,
                                        render_min=1.0, render_max=1.0, max_crop=0.0)

    def get_batch_host(self, indices):
        """The host stage: loads, augmentation draws and label algebra, all
        NumPy -> (images (B, H, W) float32 or uint16 mm, {name: (B, ...)
        array} of `prepare_batch`'s per-frame inputs)."""
        h, w = self.dcfg.height, self.dcfg.width
        u16 = self.transfer == "u16mm"
        images = np.empty((len(indices), h, w), np.uint16 if u16 else np.float32)
        rows = []
        for n, idx in enumerate(indices):
            depth, anns = self.load_composited(int(idx))
            if u16:
                # converted a frame at a time into the batch buffer
                t = np.round(depth * 1000.0)
                np.clip(t, 0, 65535, out=t)
                images[n] = t
            else:
                images[n] = depth
            params = self._params(h, w)
            pk = pack_annotations(anns, self.ecfg.max_people, self.ecfg.num_joints)
            j2, j3, bb = ad.transform_labels(params, pk.joints2d, pk.joints3d, pk.bboxes,
                                             list(SWAP_INDICES))
            j2[~pk.valid] = OOB
            rows.append((params.inv_mat, np.float32(params.depth_scale), params.flip, j2, j3, bb,
                         pk.pose_weights, pk.valid))
        names = ("inv_mats", "depth_scales", "flips", "joints2d", "joints3d", "bboxes",
                 "pose_weights", "valid")
        return images, {k: np.stack(v) for k, v in zip(names, zip(*rows))}

    def to_device(self, host) -> dict:
        """The device stage: the images and the label arrays copied to the
        device (uint16 millimetres cast to metres there), then
        `prepare_batch`."""
        images, labels = host
        if images.dtype == np.uint16:
            # crosses as int16 bits (CUDA's uint16 support is thin), widened there
            raw = torch.from_numpy(images.view(np.int16)).to(self.device)
            img = (raw.int() & 0xFFFF).float() * float(np.float32(0.001))
        else:
            img = torch.from_numpy(images).to(self.device)
        m = {k: torch.from_numpy(v).to(self.device) for k, v in labels.items()}
        return prepare_batch(img, **m, ecfg=self.ecfg, dcfg=self.dcfg,
                             pose_align=self.pose_align, with_prior=self.with_prior)

    def get_batch(self, indices) -> dict:
        return self.to_device(self.get_batch_host(indices))

    def iter_batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True):
        """Yield device batches; the order is shuffled by the dataset's
        generator when `shuffle`. The host stage and the device stage run
        on two threads PREFETCH batches ahead, so with the consumer's step
        a batch's loads, its copy and encode, and the step before it
        overlap."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        yield from _pipeline_iter((order[s:s + batch_size] for s in range(0, stop, batch_size)),
                                  [self.get_batch_host, self.to_device], PREFETCH)


class MPRealDataset:
    """Real multi-person test frames in evaluation mode: `get_batch` returns
    {"image": (B, input_y, input_x, 1) normalized depth on `device`,
    "index": the indices}. The warp comes before the clip, as in the JAX
    package (serving's `preproc_depth` clips first; the two differ where
    depth exceeds the clip).

    img_dir holds the frames named by the label file's keys; ann_file is the
    MP-3DHP label JSON (`data.labels.load_label_file`)."""

    def __init__(self, img_dir: str, ann_file: str, ecfg: EncoderConfig = EncoderConfig(),
                 dcfg: DatasetConfig = KDH3D_DATASET, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.img_dir = img_dir
        self.anno_dic, self.intrinsics = load_label_file(ann_file)
        self.ids = list(self.anno_dic.keys())
        self.ecfg = ecfg
        self.dcfg = dcfg
        self._inv_mat = ad.resize_inv_mat(dcfg.height, dcfg.width, ecfg.input_y, ecfg.input_x)

    def __len__(self):
        return len(self.ids)

    def load_composited(self, index: int):
        """(depth (H, W) float32 metres, the frame's annotation list)."""
        image_id = self.ids[index]
        depth = np.load(os.path.join(self.img_dir, image_id)).astype(np.float32)
        return depth, list(self.anno_dic[image_id])

    def gt_human_lists(self):
        """(human_gt_set_2d, human_gt_set_3d) in dataset order, the
        benchmark's prediction-JSON contract."""
        set2d, set3d = [], []
        for image_id in self.ids:
            anns = self.anno_dic[image_id]
            set2d.append([np.asarray(a["2d_joints"]).reshape(-1, 2).tolist() for a in anns])
            set3d.append([np.asarray(a["3d_joints"]).reshape(-1, 3).tolist() for a in anns])
        return set2d, set3d

    def get_batch(self, indices) -> dict:
        indices = [int(i) for i in indices]
        host = np.stack([self.load_composited(i)[0] for i in indices])
        images = torch.from_numpy(host).to(self.device)
        warped = ad.warp_depth_batch(images, self._inv_mat, self.ecfg.input_y, self.ecfg.input_x)
        depth = self.dcfg.depth
        image = div_const(warped.clamp(0.0, depth.max) - depth.mean, depth.std)
        return {"image": image[..., None], "index": np.asarray(indices)}
