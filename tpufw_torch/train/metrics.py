"""Training metrics: tokens/s/GPU and MFU (port of ``tpufw.train.metrics``).

MFU is *model* FLOPs utilization: analytic model FLOPs per token (from the
model config) over the accelerator's peak from ``utils.hardware`` — not
the FLOPs actually executed, which would reward recomputation.
"""

from __future__ import annotations

import dataclasses
import time

from tpufw_torch.utils.hardware import ChipSpec


@dataclasses.dataclass
class StepMetrics:
    step: int
    loss: float
    step_time_s: float
    tokens_per_sec_per_gpu: float
    mfu: float
    # Host time spent waiting on the data iterator before this step.
    data_wait_s: float = 0.0
    # Steps averaged into this entry (sync_every > 1 meters a WINDOW of
    # steps per host sync; step and loss are the window's last step's).
    window_steps: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Meter:
    """Times one step at a time and converts to tokens/s/GPU and MFU.

    ``tokens_per_step`` counts the global batch; ``n_gpus`` is the gang's
    device count (``tpufw``'s ``n_chips``), so tokens/s/GPU and MFU are
    per device and compare across gang sizes. With a ``registry``
    (``tpufw_torch.obs.Registry``) every ``stop`` publishes the window as
    ``tpufw``'s Meter does: step and token counters, step-time and
    data-wait histograms, step, loss, MFU and throughput gauges (the
    series keep ``tpufw``'s ``..._per_chip`` name; a chip is one GPU)."""

    def __init__(
        self,
        tokens_per_step: int,
        flops_per_token: float,
        chip: ChipSpec,
        n_gpus: int = 1,
        registry=None,
    ):
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        self.chip = chip
        self.n_gpus = max(n_gpus, 1)
        self._t0: float | None = None
        self.registry = registry
        if registry is not None:
            self._c_steps = registry.counter(
                "tpufw_train_steps_total", "optimizer steps completed"
            )
            self._c_tokens = registry.counter(
                "tpufw_train_tokens_total", "target tokens trained on"
            )
            self._h_step = registry.histogram(
                "tpufw_train_step_time_seconds",
                "per-step wall time (window average when sync_every > 1)",
            )
            self._h_wait = registry.histogram(
                "tpufw_train_data_wait_seconds",
                "per-step host wait on the input pipeline",
            )
            self._g_step = registry.gauge(
                "tpufw_train_step", "last synced optimizer step"
            )
            self._g_loss = registry.gauge(
                "tpufw_train_loss", "loss at the last synced step"
            )
            self._g_mfu = registry.gauge(
                "tpufw_train_mfu", "model FLOPs utilization (0..1)"
            )
            self._g_tps = registry.gauge(
                "tpufw_train_tokens_per_sec_per_chip",
                "throughput per chip",
            )

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int, loss, data_wait_s: float = 0.0,
             n_steps: int = 1, warmup: bool = False) -> StepMetrics:
        """``loss`` may be a device tensor: ``float(loss)`` copies it to
        the host, which waits for the step's work on the CUDA stream, and
        only then is the clock read. ``n_steps`` > 1: the time covers a
        window of that many steps; step time, throughput and
        ``data_wait_s`` (pass the window's sum) are given per step.
        ``warmup``: the window ran under the perf observatory's counter
        (a step slowed by the count): it is returned as measured and
        counted in the step and token counters, but kept out of the
        step-time and data-wait histograms and the MFU and throughput
        gauges."""
        if self._t0 is None:
            raise RuntimeError("Meter.stop() without start()")
        loss = float(loss)
        n = max(n_steps, 1)
        dt = (time.perf_counter() - self._t0) / n
        data_wait_s = data_wait_s / n
        self._t0 = None
        tps = self.tokens_per_step / dt / self.n_gpus
        mfu = tps * self.flops_per_token / self.chip.peak_bf16_flops
        if self.registry is not None:
            self._c_steps.inc(n)
            self._c_tokens.inc(self.tokens_per_step * n)
            self._g_step.set(step)
            self._g_loss.set(loss)
            if not warmup:
                # Per-step averages observed n times: _sum and _count
                # add up to the window's totals.
                self._h_step.observe(dt, n=n)
                self._h_wait.observe(data_wait_s, n=n)
                self._g_mfu.set(mfu)
                self._g_tps.set(tps)
        return StepMetrics(
            step=step,
            loss=loss,
            step_time_s=dt,
            tokens_per_sec_per_gpu=tps,
            mfu=mfu,
            data_wait_s=data_wait_s,
            window_steps=n_steps,
        )


def timed_batches(data):
    """Wrap an iterator, yielding (data_wait_s, batch)."""
    it = iter(data)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        yield time.perf_counter() - t0, batch
