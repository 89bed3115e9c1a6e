"""The mp-aug scene bank streamed through device memory in shards (the
port's counterpart of `popnet_tpu/data/streaming.py`).

`DeviceMPAugDataset` holds every (location, recording) layer on the device,
about 0.74 MB a 512x480 layer as uint16 millimetres and a uint8 mask: the
right design while the bank fits, but the real training split's 176,828
frames are far past one card's memory. This dataset splits the sample
indices into contiguous shards, and at most two shards' layer banks live on
the device at once: while the loop consumes batches of shard s, a staging
thread loads shard s+1 from disk into pinned host memory and copies it to
the card on a stream of its own, so the copy runs under the train steps.
A batch's gathers wait on the shard's ready event, and the shard's memory
is marked as used by the consuming stream (`record_stream`), so it is not
reused before the last batch that reads it has run.

Sampling is block-shuffled: the shard order and the order within a shard
are drawn afresh each epoch, and a batch mixes samples of the resident
shard only. `shard_repeats` R makes R passes over each resident shard an
epoch (R times fewer copies a frame seen). Each draw is exactly the full
bank's (`DeviceMPAugDataset._bank_batch`, the same code over the shard's
rows), so a streamed batch over a staged shard equals the full bank's for
the same indices and generator state. The backgrounds stay resident
(frame i takes background i % n_bg, so any shard may touch any).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from popnet_tpu_torch.data.datasets import (DeviceMPAugDataset, KDH3DMPAugDataset, to_u16mm,
                                            u16_to_device)

__all__ = ["StreamingDeviceMPAugDataset"]


class _Shard:
    """One staged shard: its layer banks on the device, the row of each
    recording, the event its copy records, and the seconds from the start
    of its loads to that event."""

    __slots__ = ("sid", "bank_depth", "bank_seg", "row_of", "ready", "stage_seconds")

    def __init__(self, sid, bank_depth, bank_seg, row_of, ready, stage_seconds):
        self.sid, self.bank_depth, self.bank_seg, self.row_of = sid, bank_depth, bank_seg, row_of
        self.ready, self.stage_seconds = ready, stage_seconds


class StreamingDeviceMPAugDataset(DeviceMPAugDataset):
    """mp-aug over a scene bank streamed through the device in
    double-buffered shards. Beyond `KDH3DMPAugDataset`'s arguments:
    shard_indices, the sample indices a shard (its rows, at most
    shard_indices x the locations, padded to the largest shard's), and
    shard_repeats, the passes over each resident shard an epoch."""

    def __init__(self, *args, shard_indices: int = 2048, shard_repeats: int = 1, **kw):
        KDH3DMPAugDataset.__init__(self, *args, **kw)     # the labels, not the whole bank
        if shard_indices < 1 or shard_repeats < 1:
            raise ValueError("shard_indices and shard_repeats must be >= 1")
        self.shard_indices, self.shard_repeats = shard_indices, shard_repeats
        n = len(self)
        self._shard_starts = list(range(0, n, shard_indices))
        self._shard_files: list[list[str]] = []
        for s in self._shard_starts:
            ids: dict[str, None] = {}                        # unique, in first-seen order
            for idx in range(s, min(s + shard_indices, n)):
                for loc in self.ids_list:
                    ids.setdefault(loc[idx % len(loc)])
            self._shard_files.append(list(ids))
        self._max_rows = max(len(f) for f in self._shard_files)
        self.bank_bg = self._background_bank()
        self._live_shards = 0          # staged and not yet released
        self.max_live_shards = 0
        self._lock = threading.Lock()

    @property
    def n_shards(self) -> int:
        return len(self._shard_starts)

    def shard_bytes(self) -> int:
        """Device bytes of one staged shard (uint16 depth and uint8 masks,
        padded to the largest shard's rows)."""
        return self._max_rows * self.dcfg.height * self.dcfg.width * 3

    def _stage(self, sid: int) -> _Shard:
        """Load shard `sid`'s layers and copy them to the device; on the
        card from pinned memory on a side stream, waiting (on this thread)
        for the copy's event so that `stage_seconds` is the load-to-ready
        time."""
        t0 = time.perf_counter()
        files = self._shard_files[sid]
        h, w = self.dcfg.height, self.dcfg.width
        depth = np.zeros((self._max_rows, h, w), np.uint16)
        seg = np.zeros((self._max_rows, h, w), np.uint8)
        row_of: dict[str, int] = {}
        for r, image_id in enumerate(files):
            depth[r] = to_u16mm(np.load(os.path.join(self.img_dir, image_id)))
            seg[r] = np.load(os.path.join(self.seg_dir, image_id)) > 0
            row_of[image_id] = r
        ready = None
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                side = torch.cuda.Stream()
                host_d = torch.from_numpy(depth.view(np.int16)).pin_memory()
                host_s = torch.from_numpy(seg).pin_memory()
                with torch.cuda.stream(side):
                    bank_depth = host_d.to(self.device, non_blocking=True)
                    bank_seg = host_s.to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(side)
                ready.synchronize()
        else:
            bank_depth = u16_to_device(depth, self.device)
            bank_seg = torch.from_numpy(seg).to(self.device)
        shard = _Shard(sid, bank_depth, bank_seg, row_of, ready, time.perf_counter() - t0)
        with self._lock:
            self._live_shards += 1
            self.max_live_shards = max(self.max_live_shards, self._live_shards)
        return shard

    def _use(self, shard: _Shard) -> None:
        """Make the current stream wait for the shard's copy, and mark the
        shard's memory as used by it."""
        if shard.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(shard.ready)
            shard.bank_depth.record_stream(stream)
            shard.bank_seg.record_stream(stream)

    def _release(self, shard: _Shard) -> None:
        shard.bank_depth = shard.bank_seg = None
        with self._lock:
            self._live_shards -= 1

    def get_batch(self, indices) -> dict:
        """Random access composites on the host (staging a shard for one
        batch would be all copy); training streams through iter_batches."""
        return KDH3DMPAugDataset.get_batch(self, indices)

    def iter_batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True):
        """An epoch: shards in a shuffled order, each staged on a thread
        while the one before is consumed, its indices shuffled anew for
        each of its shard_repeats passes."""
        shard_order = np.arange(self.n_shards)
        if shuffle:
            self.rng.shuffle(shard_order)
        n = len(self)
        pending: list[tuple[threading.Thread, list]] = []

        def stage_async(sid: int) -> None:
            box: list = []

            def run():
                try:
                    box.append(self._stage(sid))
                except Exception as e:          # raised on the consumer's side
                    box.append(e)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            pending.append((t, box))

        stage_async(int(shard_order[0]))
        for k in range(self.n_shards):
            t, box = pending.pop(0)
            t.join()
            if isinstance(box[0], Exception):
                raise box[0]
            shard = box[0]
            if k + 1 < self.n_shards:            # one shard in flight
                stage_async(int(shard_order[k + 1]))
            self._use(shard)
            s = self._shard_starts[shard.sid]
            local = np.arange(s, min(s + self.shard_indices, n))
            for _ in range(self.shard_repeats):
                order = local.copy()
                if shuffle:
                    self.rng.shuffle(order)
                stop = len(order) - (len(order) % batch_size if drop_last else 0)
                for b in range(0, stop, batch_size):
                    yield self._bank_batch(order[b:b + batch_size], shard.row_of,
                                           shard.bank_depth, shard.bank_seg)
            self._release(shard)
