"""Depth datasets: `.npy` frames and their labels on the host, the network's
input images and GT targets made on the device.

The port's counterpart of `popnet_tpu/data/datasets.py`:

- `prepare_batch` warps a batch of frames through per-frame augmentation
  maps (`augment_device.warp_depth_batch`), clips, normalizes, resizes the
  clipped depth to the z-grid and encodes every GT target
  (`ops.encoders.encode_targets`, with `pred_vis` the prior's visibility
  channels), all on the device; `prepare_batch_banked` first gathers the
  selected person layers of a device-resident scene bank and z-buffers
  them over a background (`data.compositing.mp_composite`);
- the training datasets draw each frame's augmentation (and, for mp-aug,
  its person layers) from the dataset's `np.random.Generator` in the JAX
  package's order: `get_batch_host` loads frames and moves their labels,
  `to_device` copies the images (float32 metres or, with
  `transfer="u16mm"`, uint16 millimetres cast on the device) and the label
  arrays to the device and runs `prepare_batch`; `iter_batches` runs the
  two stages on threads ahead of the consumer (`_pipeline_iter`), or a
  dataset's own `get_batch` on one thread where it overrides it:
  - `KDH3DDataset`: single-person frames, with `bg_aug` composited over a
    background on the host (or on the device, `load_composited_device`,
    which `data.construction` freezes sets with);
  - `KDH3DMPAugDataset`: multi-person frames z-buffered on the host from
    the per-location single-person recordings;
  - `DeviceMPAugDataset`: the same draws over a scene bank resident on the
    device (uint16 millimetres, uint8 masks): per batch only the layer
    ids, keep flags, background ids and labels cross to the device;
  - `KDH3DMPAugAdvDataset`: each person layer and its mask warped by its
    own augmentation, the background by its own, then the composite;
  - `data.streaming.StreamingDeviceMPAugDataset`: the bank in shards;
- `MPRealDataset` (evaluation): one float32 copy, the warp of a plain
  resize, clip and normalize; no targets.

One seed gives the images of the JAX package's `get_batch` bit for bit
(the warp rounds as XLA does; with {0, 1} masks every composite term is
exact) and its targets within the encoders' bars. uint16 crosses to the
card as int16 bits and is widened there (CUDA's uint16 support is thin).
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
from popnet_tpu_torch.data.compositing import bg_composite, mp_composite
from popnet_tpu_torch.data.labels import OOB, load_label_file, pack_annotations
from popnet_tpu_torch.ops.encoders import encode_targets
from popnet_tpu_torch.ops.resize import resize_bilinear_cv2

# person-location modes of the mp-aug composite: the location files each
# frame draws its people from
AUG_MODS = [[0, 3], [1, 2], [0, 1], [2, 3], [4]]
KEEP_PROB = 0.8     # the chance that each location of the drawn mode is kept
LABEL_NAMES = ("inv_mats", "depth_scales", "flips", "joints2d", "joints3d", "bboxes",
               "pose_weights", "valid")


def prepare_batch(images, inv_mats, depth_scales, flips, joints2d, joints3d, bboxes,
                  pose_weights, valid, ecfg: EncoderConfig, dcfg: DatasetConfig,
                  pose_align: bool = True, with_prior: bool = True,
                  pred_vis: bool = False) -> dict:
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
                              ecfg, dcfg.depth, pose_align=pose_align, with_prior=with_prior,
                              pred_vis=pred_vis))
    return out


def to_u16mm(arr: np.ndarray) -> np.ndarray:
    """Metres -> uint16 millimetres, rounded in float64 and clipped."""
    return np.clip(np.round(arr.astype(np.float64) * 1000.0), 0, 65535).astype(np.uint16)


def u16_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """uint16 array -> its bits as an int16 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).to(device)


def u16mm_metres(bits: torch.Tensor) -> torch.Tensor:
    """int16 bits of uint16 millimetres -> float32 metres, widened on their
    device and multiplied by f32(0.001), as the JAX package casts them."""
    return (bits.int() & 0xFFFF).float() * float(np.float32(0.001))


def prepare_batch_banked(bank_depth, bank_seg, bank_bg, layer_ids, keep, bg_ids, labels: dict,
                         far: float, ecfg: EncoderConfig, dcfg: DatasetConfig,
                         pose_align: bool = True, with_prior: bool = True,
                         pred_vis: bool = False) -> dict:
    """`prepare_batch` over a device-resident scene bank: bank_depth (N, H,
    W) int16 bits of uint16 millimetres, bank_seg (N, H, W) uint8 {0, 1},
    bank_bg (G, H, W) int16 bits; layer_ids (B, L) rows, keep (B, L) bool,
    bg_ids (B,); labels the per-frame arrays of `LABEL_NAMES`. Gathers the
    layers, z-buffers the kept ones over the background (`far` where none
    covers), then warps and encodes, all on the bank's device."""
    layers = u16mm_metres(bank_depth[layer_ids])
    masks = bank_seg[layer_ids].float()
    bg = u16mm_metres(bank_bg[bg_ids])
    images, _ = mp_composite(layers, masks, keep, bg, far)
    return prepare_batch(images, **labels, ecfg=ecfg, dcfg=dcfg, pose_align=pose_align,
                         with_prior=with_prior, pred_vis=pred_vis)


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


class _TrainDataset:
    """What the training datasets share: the label file, the configs, the
    generator, the `.npy` loads, the augmentation draws, the two-stage batch
    path (`get_batch_host`, `to_device`) and `iter_batches`. Subclasses
    give `load_composited(index) -> (depth (H, W) float32 metres, the
    frame's annotation list)` or their own `get_batch`."""

    def __init__(self, img_dir: str, ann_file: str, ecfg: EncoderConfig = EncoderConfig(),
                 dcfg: DatasetConfig = KDH3D_DATASET, pose_align: bool = True,
                 with_prior: bool = True, pred_vis: bool = False, augment: bool = True,
                 hflip: bool = False, seed: int = 0,
                 transfer: str = "f32", cache_images: bool = False,
                 device: str | torch.device = "cuda"):
        if transfer not in ("f32", "u16mm"):
            raise ValueError(f"transfer must be 'f32' or 'u16mm', got {transfer!r}")
        self.device = resolve_device(device)
        self.img_dir = img_dir
        self.anno_dic, self.intrinsics = load_label_file(ann_file)
        self.ids = list(self.anno_dic.keys())
        self.ecfg, self.dcfg = ecfg, dcfg
        self.pose_align, self.with_prior, self.pred_vis = pose_align, with_prior, pred_vis
        self.augment, self.hflip = augment, hflip
        self.transfer = transfer
        # decoded frames kept in host RAM across epochs (~1 MB a 512x480
        # frame); read-only by convention, every consumer derives new arrays
        self.cache_images = cache_images
        self._npy_cache: dict[str, np.ndarray] = {}
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.ids)

    def rng_state(self):
        """The generator's state, which a checkpoint keeps (`set_rng_state`)."""
        return self.rng.bit_generator.state

    def set_rng_state(self, state) -> None:
        self.rng.bit_generator.state = state

    def _load_npy(self, path: str) -> np.ndarray:
        if not self.cache_images:
            return np.load(path).astype(np.float32)
        arr = self._npy_cache.get(path)
        if arr is None:
            arr = np.load(path).astype(np.float32)
            arr.setflags(write=False)
            self._npy_cache[path] = arr
        return arr

    def _params(self, h: int, w: int) -> ad.AffineParams:
        """One frame's augmentation draw, or the plain resize's without
        `augment` (one draw of the generator, as in the JAX package)."""
        iy, ix = self.ecfg.input_y, self.ecfg.input_x
        if self.augment:
            return ad.sample_augment_params(self.rng, h, w, iy, ix, rotate_deg=10.0,
                                            render_min=0.7, render_max=1.2, max_crop=0.1,
                                            hflip=self.hflip)
        return ad.sample_augment_params(self.rng, h, w, iy, ix, rotate_deg=0.0,
                                        render_min=1.0, render_max=1.0, max_crop=0.0)

    def _label_row(self, params: ad.AffineParams, anns) -> tuple:
        """A frame's per-frame inputs of `prepare_batch` (`LABEL_NAMES`),
        its labels moved by the augmentation."""
        pk = pack_annotations(anns, self.ecfg.max_people, self.ecfg.num_joints)
        j2, j3, bb = ad.transform_labels(params, pk.joints2d, pk.joints3d, pk.bboxes,
                                         list(SWAP_INDICES))
        j2[~pk.valid] = OOB
        return (params.inv_mat, np.float32(params.depth_scale), params.flip, j2, j3, bb,
                pk.pose_weights, pk.valid)

    def _labels_to_device(self, rows) -> dict:
        return {k: torch.from_numpy(np.stack(v)).to(self.device)
                for k, v in zip(LABEL_NAMES, zip(*rows))}

    def _prepare(self, images, labels: dict) -> dict:
        return prepare_batch(images, **labels, ecfg=self.ecfg, dcfg=self.dcfg,
                             pose_align=self.pose_align, with_prior=self.with_prior,
                             pred_vis=self.pred_vis)

    def get_batch_host(self, indices):
        """The host stage: loads, augmentation draws and label algebra, all
        NumPy -> (images (B, H, W) float32 or uint16 mm, the label rows)."""
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
            rows.append(self._label_row(self._params(h, w), anns))
        return images, rows

    def to_device(self, host) -> dict:
        """The device stage: the images and the label arrays copied to the
        device (uint16 millimetres cast to metres there), then
        `prepare_batch`."""
        images, rows = host
        if images.dtype == np.uint16:
            img = u16mm_metres(u16_to_device(images, self.device))
        else:
            img = torch.from_numpy(images).to(self.device)
        return self._prepare(img, self._labels_to_device(rows))

    def get_batch(self, indices) -> dict:
        return self.to_device(self.get_batch_host(indices))

    def iter_batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True):
        """Yield device batches; the order is shuffled by the dataset's
        generator when `shuffle`. The host stage and the device stage run
        on two threads PREFETCH batches ahead, so with the consumer's step
        a batch's loads, its copy and encode, and the step before it
        overlap; a dataset with its own `get_batch` runs it on one thread."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        if type(self).get_batch is _TrainDataset.get_batch:
            stages = [self.get_batch_host, self.to_device]
        else:
            stages = [self.get_batch]
        yield from _pipeline_iter((order[s:s + batch_size] for s in range(0, stop, batch_size)),
                                  stages, PREFETCH)


class KDH3DDataset(_TrainDataset):
    """Single-person KDH3D frames for training, optionally composited over
    backgrounds (`bg_aug`): `get_batch(indices)` returns the device batch of
    `prepare_batch`. With `augment` each frame draws a random rotation,
    render scale, crop (and flip, with `hflip`); without it, the plain
    resize."""

    def __init__(self, img_dir: str, ann_file: str, bg_aug: bool = False,
                 bg_file: str | None = None, bg_dir: str | None = None,
                 seg_dir: str | None = None, device: str | torch.device = "cuda", **kw):
        super().__init__(img_dir, ann_file, device=device, **kw)
        self.bg_aug = bg_aug
        if bg_aug:
            with open(bg_file) as f:
                self.bg_list = list(json.load(f).values())
            _pyrandom.Random(kw.get("seed", 0)).shuffle(self.bg_list)
            self.bg_dir, self.seg_dir = bg_dir, seg_dir

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

    def load_composited_device(self, index: int):
        """`load_composited` with the composite on the dataset's device
        (`compositing.bg_composite`): (depth (H, W) float32 tensor there,
        the frame's annotation list); for {0, 1} masks the same image bit
        for bit."""
        image_id = self.ids[index]
        dev = self.device
        depth = torch.from_numpy(self._load_npy(os.path.join(self.img_dir, image_id))).to(dev)
        if self.bg_aug:
            entry = self.bg_list[index % len(self.bg_list)]
            bg = self._load_npy(os.path.join(self.bg_dir, entry["file_name"]))
            fg = self._load_npy(os.path.join(self.seg_dir, image_id))
            depth = bg_composite(depth, torch.from_numpy(fg).to(dev), torch.from_numpy(bg).to(dev))
        return depth, list(self.anno_dic[image_id])


class KDH3DMPAugDataset(_TrainDataset):
    """Synthetic multi-person frames: the z-buffer composite of per-location
    single-person recordings (ann_files, one label file a location) over a
    background, on the host. Frame `index` draws a location mode of
    AUG_MODS, keeps each of its locations with probability KEEP_PROB (one
    uniform draw each), at least one person (a location drawn if none was
    kept), recording index % n of each location and background index %
    n_bg; then its augmentation. len() is the longest location's."""

    def __init__(self, img_dir: str, ann_files, bg_file: str, bg_dir: str, seg_dir: str,
                 device: str | torch.device = "cuda", **kw):
        super().__init__(img_dir, ann_files[0], device=device, **kw)
        self.anno_dic_list = [self.anno_dic]
        self.ids_list = [list(self.anno_dic.keys())]
        for f in ann_files[1:]:
            dic, _ = load_label_file(f)
            self.anno_dic_list.append(dic)
            self.ids_list.append(list(dic.keys()))
        with open(bg_file) as f:
            self.bg_list = list(json.load(f).values())
        self.bg_dir, self.seg_dir = bg_dir, seg_dir
        self._len = max(len(i) for i in self.ids_list)

    def __len__(self):
        return self._len

    def _draw_layers(self, index: int):
        """The person layers of frame `index`, the one place their draws
        are made: (image ids, annotation list)."""
        image_ids, anns = [], []

        def add(ii):
            image_id = self.ids_list[ii][index % len(self.ids_list[ii])]
            image_ids.append(image_id)
            anns.extend(dict(a) for a in self.anno_dic_list[ii][image_id])

        for ii in AUG_MODS[int(self.rng.integers(0, len(AUG_MODS)))]:
            if self.rng.uniform() > KEEP_PROB:
                continue
            add(ii % len(self.ids_list))    # fewer than 5 location files wrap
        if not anns:
            add(int(self.rng.integers(0, len(self.ids_list))))
        return image_ids, anns

    def _bg_path(self, index: int) -> str:
        return os.path.join(self.bg_dir, self.bg_list[index % len(self.bg_list)]["file_name"])

    def _host_layers(self, index: int):
        image_ids, anns = self._draw_layers(index)
        layers = np.stack([self._load_npy(os.path.join(self.img_dir, i)) for i in image_ids])
        masks = np.stack([self._load_npy(os.path.join(self.seg_dir, i)) for i in image_ids])
        return layers, masks, self._load_npy(self._bg_path(index)), anns

    def load_composited(self, index: int):
        """(the composite (H, W) float32 metres, its people's annotations):
        per pixel the nearest masked layer depth, the background where no
        mask covers, in NumPy."""
        layers, masks, bg, anns = self._host_layers(index)
        cand = np.where(masks > 0, layers * masks, 2.0 * self.dcfg.depth.max)
        fg_union = masks.max(axis=0)
        image = cand.min(axis=0) * fg_union + bg * (1.0 - fg_union)
        return image.astype(np.float32), anns

    def load_composited_device(self, index: int):
        """`load_composited` with the pixel work on the dataset's device
        (`compositing.mp_composite`): the same draws and, for {0, 1} masks,
        the same image bit for bit (on the device)."""
        layers, masks, bg, anns = self._host_layers(index)
        dev = self.device
        image, _ = mp_composite(torch.from_numpy(layers).to(dev)[None],
                                torch.from_numpy(masks).to(dev)[None],
                                torch.ones((1, len(layers)), dtype=torch.bool, device=dev),
                                torch.from_numpy(bg).to(dev)[None], 2.0 * self.dcfg.depth.max)
        return image[0], anns


class DeviceMPAugDataset(KDH3DMPAugDataset):
    """mp-aug with the whole scene bank resident on the device: every
    (location, recording) layer once, as uint16 millimetres (int16 bits)
    and a uint8 mask, and the backgrounds as uint16 millimetres, uploaded
    when the dataset is made. A batch draws exactly as `KDH3DMPAugDataset`
    draws (the generators stay in lockstep), moves only (B, L) layer ids
    and keep flags, (B,) background ids and the label rows to the device,
    and gathers, composites, warps and encodes there
    (`prepare_batch_banked`). Quantizing to millimetres commutes with the
    z-buffer but at sub-millimetre ties."""

    MAX_LAYERS = max(len(m) for m in AUG_MODS)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._row: dict[str, int] = {}
        depths, segs = [], []
        for ids in self.ids_list:
            for image_id in ids:
                if image_id not in self._row:
                    self._row[image_id] = len(depths)
                    depths.append(to_u16mm(np.load(os.path.join(self.img_dir, image_id))))
                    segs.append(np.load(os.path.join(self.seg_dir, image_id)) > 0)
        self.bank_depth = u16_to_device(np.stack(depths), self.device)
        self.bank_seg = torch.from_numpy(np.stack(segs).astype(np.uint8)).to(self.device)
        self.bank_bg = self._background_bank()

    def _background_bank(self) -> torch.Tensor:
        return u16_to_device(np.stack([to_u16mm(np.load(os.path.join(self.bg_dir,
                                                                       e["file_name"])))
                                       for e in self.bg_list]), self.device)

    def get_batch(self, indices) -> dict:
        return self._bank_batch(indices, self._row, self.bank_depth, self.bank_seg)

    def draw_batch(self, indices, row_of: dict):
        """The host part of a banked batch, its draws (those of
        `KDH3DMPAugDataset`, in its order) and label algebra -> (layer_ids
        (B, L) rows of `row_of`, keep (B, L), bg_ids (B,), the label rows)."""
        h, w = self.dcfg.height, self.dcfg.width
        layer_ids = np.zeros((len(indices), self.MAX_LAYERS), np.int64)
        keep = np.zeros((len(indices), self.MAX_LAYERS), bool)
        bg_ids = np.zeros(len(indices), np.int64)
        rows = []
        for n, idx in enumerate(indices):
            idx = int(idx)
            image_ids, anns = self._draw_layers(idx)
            for slot, image_id in enumerate(image_ids):
                layer_ids[n, slot] = row_of[image_id]
                keep[n, slot] = True
            bg_ids[n] = idx % len(self.bg_list)
            rows.append(self._label_row(self._params(h, w), anns))
        return layer_ids, keep, bg_ids, rows

    def _bank_batch(self, indices, row_of: dict, bank_depth, bank_seg) -> dict:
        """One banked batch over the layer bank (bank_depth, bank_seg) whose
        rows `row_of` names: `draw_batch` on the host, then
        `prepare_batch_banked` on the bank's device. The streaming bank
        calls it with its staged shards."""
        layer_ids, keep, bg_ids, rows = self.draw_batch(indices, row_of)
        dev = bank_depth.device
        return prepare_batch_banked(
            bank_depth, bank_seg, self.bank_bg, torch.from_numpy(layer_ids).to(dev),
            torch.from_numpy(keep).to(dev), torch.from_numpy(bg_ids).to(dev),
            self._labels_to_device(rows), 2.0 * self.dcfg.depth.max, self.ecfg, self.dcfg,
            pose_align=self.pose_align, with_prior=self.with_prior, pred_vis=self.pred_vis)


class KDH3DMPAugAdvDataset(KDH3DMPAugDataset):
    """Adversarial mp-aug: each person of a frame is augmented on its own
    (its layer and mask warped together to the network input by its own
    draw, the mask kept where the warp is > 0), the background by its own
    draw (no rotation, crop or flip, render scale up to 1.2), then the
    z-buffer composite and the encoders, with the identity warp, on the
    device. Up to max_people people a frame, every annotation of a chosen
    recording a person."""

    def get_batch(self, indices) -> dict:
        far = 2.0 * self.dcfg.depth.max
        h, w = self.dcfg.height, self.dcfg.width
        iy, ix = self.ecfg.input_y, self.ecfg.input_x
        P, K = self.ecfg.max_people, self.ecfg.num_joints
        B = len(indices)
        layers = np.zeros((B, P, h, w), np.float32)
        masks = np.zeros((B, P, h, w), np.float32)
        keep = np.zeros((B, P), bool)
        inv_mats = np.zeros((B, P, 2, 3), np.float32)
        scales = np.ones((B, P), np.float32)
        flips = np.zeros((B, P), bool)
        j2 = np.full((B, P, K, 2), OOB, np.float32)
        j3 = np.zeros((B, P, K, 3), np.float32)
        bb = np.zeros((B, P, 4), np.float32)
        pw = np.ones((B, P), np.float32)
        bgs, bg_params = [], []
        for b, idx in enumerate(indices):
            idx = int(idx)
            chosen = []
            for ii in AUG_MODS[int(self.rng.integers(0, len(AUG_MODS)))]:
                if self.rng.uniform() > KEEP_PROB:
                    continue
                chosen.append(ii % len(self.ids_list))
            if not chosen:
                chosen = [int(self.rng.integers(0, len(self.ids_list)))]
            n = 0
            for ii in chosen:
                image_id = self.ids_list[ii][idx % len(self.ids_list[ii])]
                params = self._params(h, w)
                for ann in self.anno_dic_list[ii][image_id][:P - n]:
                    pk = pack_annotations([ann], 1, K)
                    tj2, tj3, tbb = ad.transform_labels(params, pk.joints2d, pk.joints3d,
                                                        pk.bboxes, list(SWAP_INDICES))
                    j2[b, n], j3[b, n], bb[b, n] = tj2[0], tj3[0], tbb[0]
                    pw[b, n] = pk.pose_weights[0]
                    layers[b, n] = self._load_npy(os.path.join(self.img_dir, image_id))
                    masks[b, n] = self._load_npy(os.path.join(self.seg_dir, image_id))
                    inv_mats[b, n] = params.inv_mat
                    scales[b, n] = params.depth_scale
                    flips[b, n] = params.flip
                    keep[b, n] = True
                    n += 1
            bgs.append(self._load_npy(self._bg_path(idx)))
            bg_params.append(ad.sample_augment_params(
                self.rng, h, w, iy, ix, rotate_deg=0.0, render_min=0.7, render_max=1.2,
                max_crop=0.0) if self.augment else self._params(h, w))

        dev = self.device
        t = lambda a: torch.from_numpy(a).to(dev)
        inv, fl = t(inv_mats.reshape(B * P, 2, 3)), t(flips.reshape(B * P))
        warped = ad.warp_depth_batch(t(layers.reshape(B * P, h, w)), inv, iy, ix,
                                     depth_scales=t(scales.reshape(B * P)), flips=fl)
        wmasks = ad.warp_depth_batch(t(masks.reshape(B * P, h, w)), inv, iy, ix,
                                     depth_scales=torch.ones(B * P, device=dev), flips=fl) > 0
        bg_warped = ad.warp_depth_batch(
            t(np.stack(bgs)), t(np.stack([p.inv_mat for p in bg_params])), iy, ix,
            depth_scales=t(np.array([p.depth_scale for p in bg_params], np.float32)),
            flips=t(np.array([p.flip for p in bg_params])))
        composited, _ = mp_composite(warped.reshape(B, P, iy, ix),
                                     wmasks.float().reshape(B, P, iy, ix), t(keep), bg_warped,
                                     far)
        ident = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=dev).expand(B, 2, 3)
        return self._prepare(composited, {
            "inv_mats": ident, "depth_scales": torch.ones(B, device=dev),
            "flips": torch.zeros(B, dtype=torch.bool, device=dev), "joints2d": t(j2),
            "joints3d": t(j3), "bboxes": t(bb), "pose_weights": t(pw), "valid": t(keep)})


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
