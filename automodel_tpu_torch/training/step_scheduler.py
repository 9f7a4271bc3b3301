"""Step scheduling, port of ``automodel_tpu/training/step_scheduler.py``:
epochs, grad-accumulation groups, ``max_steps``, the log, checkpoint and
validation cadences, the (step, epoch) state a checkpoint carries, and
the stop at the next step boundary on a shutdown request (SIGTERM, through
``install_signal_handler`` or the recipe's preemption handler)."""

from __future__ import annotations

import signal
from typing import Any, Iterator, Optional


class StepScheduler:
    def __init__(
        self,
        grad_acc_steps: int = 1,
        ckpt_every_steps: int = 0,
        val_every_steps: int = 0,
        log_every_steps: int = 1,
        num_epochs: int = 1,
        max_steps: Optional[int] = None,
        dataloader: Any = None,
    ):
        self.grad_acc_steps = int(grad_acc_steps)
        self.ckpt_every_steps = int(ckpt_every_steps)
        self.val_every_steps = int(val_every_steps)
        self.log_every_steps = int(log_every_steps)
        self.num_epochs = int(num_epochs)
        self.max_steps = max_steps
        self.dataloader = dataloader
        self.step = 0  # optimizer steps taken
        self.epoch = 0
        self._shutdown = False
        self._handler = None

    # -- graceful shutdown --------------------------------------------------
    def install_signal_handler(self, signals: tuple = (signal.SIGTERM,)) -> None:
        """Install the stop-at-step-boundary handler, chaining any handler
        already installed; the caller restores it (``restore_signal_handlers``)
        after the end-of-run save."""
        from automodel_tpu_torch.resilience.preemption import PreemptionHandler

        if self._handler is None:
            self._handler = PreemptionHandler(
                signals=signals, on_preempt=self.request_shutdown,
                log_message="stopping at the next step boundary (graceful shutdown)",
            )
        self._handler.install()

    def restore_signal_handlers(self) -> None:
        if self._handler is not None:
            self._handler.restore()

    def request_shutdown(self) -> None:
        """Stop at the next step boundary (the preemption handler calls
        this so SIGTERM drains the loop)."""
        self._shutdown = True

    @property
    def shutdown_requested(self) -> bool:
        return self._shutdown

    def __iter__(self) -> Iterator[Any]:
        """One item per optimizer step: a list of ``grad_acc_steps``
        microbatches (a trailing partial group of an epoch is dropped), or,
        when the dataloader is the prefetch pipeline (``yields_groups``,
        data/prefetch.py), the ``PreparedBatch`` it yields as it is: the
        pipeline groups and drops the tail in its producer thread. The
        epoch budget and ``max_steps`` stay here on both paths."""
        grouped = bool(getattr(self.dataloader, "yields_groups", False))
        while self.epoch < self.num_epochs:
            group: list = []
            for batch in self.dataloader:
                if not grouped:
                    group.append(batch)
                    if len(group) < self.grad_acc_steps:
                        continue
                if self.max_steps is not None and self.step >= self.max_steps:
                    return
                # the step number of the optimizer step being taken, as
                # TrainState.step reads after it
                self.step += 1
                yield batch if grouped else group
                group = []
                if self._shutdown:
                    return
            self.epoch += 1
            # a signal landing in the epoch tail stops here, not an epoch later
            if self._shutdown:
                return

    @property
    def is_ckpt_step(self) -> bool:
        return self.ckpt_every_steps > 0 and self.step % self.ckpt_every_steps == 0

    @property
    def is_val_step(self) -> bool:
        return self.val_every_steps > 0 and self.step % self.val_every_steps == 0

    @property
    def is_log_step(self) -> bool:
        return self.log_every_steps > 0 and self.step % self.log_every_steps == 0

    def state_dict(self) -> dict:
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.step = state["step"]
        self.epoch = state["epoch"]
