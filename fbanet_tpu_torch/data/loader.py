"""Host-side burst loader: a worker thread pool, a bounded prefetch queue and
asynchronous copies to the card (counterpart of fbanet_tpu/data/loader.py).

Workers decode and assemble samples (cv2's and the native pool's PNG
decode release the GIL); a producer thread stacks batches into a queue
`prefetch_depth` deep. With `device` on a CUDA card the producer pins each
batch and copies it to the card with `non_blocking=True` on a side stream
of its own, and records an event after the copy: the copy of batch N+1
overlaps the card's work on batch N. The consumer makes its current stream
wait on that event, and `record_stream`s the tensors on it, so the caching
allocator does not hand their memory out again while the consumer's work
may still read it.

With `rank` / `world` (data parallelism, `parallel/mesh.py`) the loader
assembles only its rank's rows of each global batch of `batch_size`: rows
[rank b, (rank + 1) b), b = batch_size / world, of the batch the
single-process loader would make, each sample at its absolute position in
the epoch and so with its own augmentation rng. `len()` and `start_step`
count global batches. `pad_last` pads the final global batch to
`batch_size` first, so every rank gets b rows and its own `valid` count,
which may be 0.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fbanet_tpu_torch.data.realbsr import RealBSRDataset
from fbanet_tpu_torch.parallel.mesh import row_block


class BurstLoader:
    """Iterate epochs of batched bursts from a `RealBSRDataset`.

    `drop_last` defaults to True on the train split, False elsewhere.
    `pad_last` pads the final partial batch to the full batch size by
    repeating its last sample and reports the real count as
    `batch["valid"]` (`burst_name` stays unpadded). `device=None` yields
    numpy arrays; a torch device yields tensors there. `rank` / `world`:
    this rank's rows of each global batch; `world` must divide
    `batch_size`.
    """

    def __init__(
        self,
        dataset: RealBSRDataset,
        *,
        batch_size: int,
        num_workers: int = 8,
        prefetch_depth: int = 2,
        drop_last: bool | None = None,
        device: torch.device | str | None = None,
        pad_last: bool = False,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
    ) -> None:
        self.rows = row_block(batch_size, rank, world)
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = max(1, prefetch_depth)
        self.drop_last = (dataset.split == "train") if drop_last is None else drop_last
        if world > 1 and not (self.drop_last or pad_last):
            raise ValueError("a loader over ranks pads (pad_last) or drops "
                             "(drop_last) the final partial batch")
        self.device = None if device is None else torch.device(device)
        self.pad_last = pad_last
        self.seed = seed
        self._stream = None
        if self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)

    def __len__(self) -> int:
        n = self.dataset.shard_size
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _stage(self, batch: dict) -> dict:
        """Tensors of the batch's arrays on `device`: on a card, pinned and
        copied on the side stream, with the copy's event in "_ready"."""
        keys = [k for k in ("LR", "HR") if k in batch]
        if self._stream is None:
            for k in keys:
                batch[k] = torch.from_numpy(batch[k]).to(self.device)
            return batch
        with torch.cuda.stream(self._stream):
            for k in keys:
                host = torch.from_numpy(batch[k]).pin_memory()
                batch[k] = host.to(self.device, non_blocking=True)
            batch["_ready"] = torch.cuda.Event()
            batch["_ready"].record(self._stream)
        return batch

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[dict]:
        """Yield batches {'LR': [B, F, h, w, C], 'HR': [B, H, W, C],
        'burst_name': list}.

        `start_step` skips the first batches without decoding them; every
        sample keeps its absolute position in the epoch, and so its rng
        (seeded by (seed, epoch, position)): a resumed epoch sees the
        samples of the uninterrupted one.
        """
        indices = self.dataset.epoch_indices(epoch)
        if self.drop_last:
            indices = indices[: (len(indices) // self.batch_size) * self.batch_size]
        if len(indices) == 0:
            return
        n_real = len(indices)

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def load_one(pos_idx: tuple[int, int]) -> dict:
            pos, idx = pos_idx
            rng = np.random.default_rng((self.seed, epoch, int(pos)))
            return self.dataset.load(int(idx), rng)

        def producer() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for start in range(start_step * self.batch_size,
                                       len(indices), self.batch_size):
                        if stop.is_set():
                            return
                        chunk = [(start + o, i) for o, i in
                                 enumerate(indices[start:start + self.batch_size])]
                        if self.pad_last:
                            chunk += chunk[-1:] * (self.batch_size - len(chunk))
                        # this rank's rows; a padded row repeats the last
                        # sample, which is loaded once
                        chunk = chunk[self.rows]
                        valid = max(0, min(len(chunk), n_real - start
                                           - self.rows.start))
                        samples = list(pool.map(load_one,
                                                chunk[:max(1, valid)]))
                        samples += samples[-1:] * (len(chunk) - len(samples))
                        batch = {
                            "LR": np.stack([s["LR"] for s in samples]),
                            "burst_name": [s["burst_name"]
                                           for s in samples[:valid]],
                        }
                        if self.pad_last:
                            batch["valid"] = valid
                        if "HR" in samples[0]:  # absent for GT-free test data
                            batch["HR"] = np.stack([s["HR"] for s in samples])
                        if self.device is not None:
                            batch = self._stage(batch)
                        out_q.put(batch)
            except Exception as exc:  # handed to the consumer
                out_q.put(exc)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                ready = item.pop("_ready", None)
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    for k in ("LR", "HR"):
                        if k in item:
                            item[k].record_stream(stream)
                yield item
        finally:
            stop.set()
            # drain while joining: the producer may be blocked in a full
            # out_q.put, and each queued batch holds card memory
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.1)
