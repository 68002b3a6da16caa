"""Mean ms an IVF ``search_collect`` blocks on the device's answer:
``ivf.pull`` spans over ``search_collect`` calls (``utils/spans``, in
``engine/ivf.py``)."""

from benchmark import readers


def read(r: dict) -> float | None:
    pulls, ms = readers.hot(r, "ivf.pull")
    collects, _ = readers.hot(r, "ivf.IvfDeviceIndex.search_collect")
    return ms / collects if pulls and collects else None
