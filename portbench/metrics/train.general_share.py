"""The device seconds of the traced steps' kernels that the lowering ran
by its general paths (``egt.executor.kernel`` spans whose ``path`` is
``general-*``: index tensors, masks and elementwise passes rather than
one einsum or a kernel) over the device seconds of the steps' target
runs (``egt.executor.run``), in %."""

from portbench import spans


def read(run):
    return spans.device_share(
        run, lambda a: str(a.get("path") or "").startswith("general-"))
