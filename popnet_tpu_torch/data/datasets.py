"""The MP-3DHP evaluation dataset: depth frames and their labels on the host,
the network's input images made on the device.

The port's counterpart of the evaluation mode of the JAX package's
`MPRealDataset` (`popnet_tpu/data/datasets.py`): `get_batch` loads the
batch's `.npy` frames on the host, moves them to the device in one float32
copy, and there warps them to the network's input size
(`augment_device.warp_depth_batch` with the inverse map of a plain resize),
clips to [0, depth.max] and normalizes.
The warp comes before the clip, as in the JAX package: serving's
`preproc_depth` clips first, and the two differ where depth exceeds the clip.
The training flavours, `iter_batches`, the uint16 transfer and the host
image cache (which only training sets) are not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from popnet_tpu_torch.core.config import KDH3D_DATASET, DatasetConfig, EncoderConfig
from popnet_tpu_torch.core.device import resolve_device
from popnet_tpu_torch.core.numerics import div_const
from popnet_tpu_torch.data import augment_device as ad
from popnet_tpu_torch.data.labels import load_label_file


class MPRealDataset:
    """Real multi-person test frames in evaluation mode: `get_batch` returns
    {"image": (B, input_y, input_x, 1) normalized depth on `device`,
    "index": the indices}.

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
