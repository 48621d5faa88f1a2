"""Training bookkeeping + observability (counterpart of
surfelmapping_tpu/models/train_utils.py; reference SPADE/util parity).

  * IterationCounter — epoch/iteration cursor persisted to ``iter.txt`` so
    interrupted runs resume mid-epoch (ref SPADE/util/iter_counter.py:1-74);
  * Visualizer — appends losses to ``loss_log.txt``, saves visual triplets
    (label / synthesized / real) as PNGs and regenerates a static HTML
    gallery (ref SPADE/util/visualizer.py:1-159 + util/html.py);
  * save_options / load_options — pickles the parsed options next to the
    checkpoint and writes the human-readable ``opt.txt`` so a resumed run
    trains under identical flags (ref SPADE/options/base_options.py:118-146).

In a data-parallel job each takes the job's ``comm`` and only rank 0 writes
(and the Visualizer prints); every rank keeps the same cursor.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np


def _lead(comm) -> bool:
    """Whether this process writes: no job, or rank 0 of one."""
    return comm is None or comm.rank == 0


class IterationCounter:
    """Epoch/iter cursor with ``iter.txt`` persistence (written by rank 0)."""

    def __init__(
        self,
        ckpt_dir: str,
        dataset_size: int,
        batch_size: int,
        niter: int,
        niter_decay: int,
        continue_train: bool = False,
        comm=None,
    ):
        self.lead = _lead(comm)
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self.first_epoch = 1
        self.total_epochs = niter + niter_decay
        self.epoch_iter = 0
        self.iter_record_path = os.path.join(ckpt_dir, "iter.txt")
        if continue_train:
            try:
                self.first_epoch, self.epoch_iter = np.loadtxt(
                    self.iter_record_path, delimiter=",", dtype=int
                )
                print(
                    f"Resuming from epoch {self.first_epoch} at iteration "
                    f"{self.epoch_iter}"
                )
            except OSError:
                print(
                    f"Could not load iteration record at "
                    f"{self.iter_record_path}. Starting from beginning."
                )
        self.total_steps_so_far = (
            (self.first_epoch - 1) * dataset_size + self.epoch_iter
        )
        self.current_epoch = self.first_epoch

    def training_epochs(self):
        return range(self.first_epoch, self.total_epochs + 1)

    def record_epoch_start(self, epoch: int) -> None:
        self.epoch_start_time = time.time()
        self.epoch_iter = 0
        self.current_epoch = epoch

    def record_one_iteration(self) -> None:
        self.total_steps_so_far += self.batch_size
        self.epoch_iter += self.batch_size

    def record_epoch_end(self) -> None:
        dt = time.time() - self.epoch_start_time
        print(
            f"End of epoch {self.current_epoch} / {self.total_epochs} \t "
            f"Time Taken: {dt:.0f} sec"
        )
        self._write(self.current_epoch + 1, 0)

    def record_current_iter(self) -> None:
        self._write(self.current_epoch, self.epoch_iter)

    def _write(self, epoch: int, epoch_iter: int) -> None:
        if self.lead:
            np.savetxt(self.iter_record_path, (epoch, epoch_iter), delimiter=",", fmt="%d")

    def _every(self, freq: int) -> bool:
        return (self.total_steps_so_far % freq) < self.batch_size

    def needs_saving(self, save_latest_freq: int = 5000) -> bool:
        return self._every(save_latest_freq)

    def needs_printing(self, print_freq: int = 100) -> bool:
        return self._every(print_freq)

    def needs_displaying(self, display_freq: int = 100) -> bool:
        return self._every(display_freq)


def to_uint8_image(t: np.ndarray) -> np.ndarray:
    """[-1,1] float HWC -> u8 HWC (ref util.tensor2im)."""
    return np.clip((np.asarray(t) + 1.0) * 127.5, 0, 255).astype(np.uint8)


class Visualizer:
    """Loss log + PNG dumps + static HTML gallery (rank 0's alone: on
    another rank every method does nothing)."""

    def __init__(self, ckpt_dir: str, name: str = "spade", comm=None):
        self.lead = _lead(comm)
        self.web_dir = os.path.join(ckpt_dir, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        self.log_name = os.path.join(ckpt_dir, "loss_log.txt")
        self.name = name
        self._gallery: list[tuple[int, int, list[str]]] = []
        if self.lead:
            os.makedirs(self.img_dir, exist_ok=True)
            with open(self.log_name, "a") as f:
                f.write(f"=== Training Loss ({time.strftime('%c')}) ===\n")

    def print_current_errors(self, epoch: int, i: int, errors: dict) -> None:
        if not self.lead:
            return
        msg = f"(epoch: {epoch}, iters: {i}) " + " ".join(
            f"{k}: {float(v):.3f}" for k, v in sorted(errors.items())
        )
        print(msg, flush=True)
        with open(self.log_name, "a") as f:
            f.write(msg + "\n")

    def display_current_results(
        self, visuals: dict, epoch: int, step: int
    ) -> None:
        """``visuals`` maps name -> [-1,1] float HWC array."""
        if not self.lead:
            return
        from PIL import Image

        files = []
        for label, img in visuals.items():
            fn = f"epoch{epoch:03d}_iter{step:07d}_{label}.png"
            Image.fromarray(to_uint8_image(img)).save(
                os.path.join(self.img_dir, fn)
            )
            files.append(fn)
        self._gallery.append((epoch, step, files))
        self._write_html()

    def _write_html(self) -> None:
        rows = []
        for epoch, step, files in reversed(self._gallery):
            cells = "".join(
                f'<td><p>{fn.rsplit("_", 1)[-1][:-4]}</p>'
                f'<img src="images/{fn}" width="256"/></td>'
                for fn in files
            )
            rows.append(
                f"<h3>epoch {epoch}, step {step}</h3>"
                f"<table><tr>{cells}</tr></table>"
            )
        html = (
            f"<html><head><title>{self.name}</title></head><body>"
            + "\n".join(rows)
            + "</body></html>"
        )
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(html)


def save_options(ckpt_dir: str, opts, comm=None) -> None:
    if not _lead(comm):
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "opt.pkl"), "wb") as f:
        pickle.dump(vars(opts) if hasattr(opts, "__dict__") else opts, f)
    with open(os.path.join(ckpt_dir, "opt.txt"), "w") as f:
        d = vars(opts) if hasattr(opts, "__dict__") else opts
        f.write("----------------- Options ---------------\n")
        for k, v in sorted(d.items()):
            f.write(f"{k}: {v}\n")
        f.write("----------------- End -------------------\n")


def load_options(ckpt_dir: str) -> dict:
    with open(os.path.join(ckpt_dir, "opt.pkl"), "rb") as f:
        return pickle.load(f)
