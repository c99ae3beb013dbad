"""The digital twin: a deterministic discrete-event simulator of the
control plane.

Counterpart of ``saturn_tpu/twin/``. The twin runs the port's production
code (``solver/anytime.py``, ``service/admission.py``,
``resilience/replan.py``, the gateway's shed and dedup path) against
virtual slices: device counts, device memory and failure processes are
parameters, a seeded analytic oracle prices the jobs, and a
:class:`~saturn_tpu_torch.twin.engine.VirtualEngine` advances a simulated
clock in place of running steps. It uses no tensor and no device.

Modules:

- ``clock``: virtual time (a ``time.*`` patch) and a deterministic event queue
- ``arrivals``: seeded Poisson arrivals with diurnal bursts
- ``fleet``: virtual devices and slices, seeded failure schedules
- ``oracle``: the static cost and memory model, prior-built strategies
- ``engine``: the VirtualEngine (re-exports the engine's forecast arithmetic)
- ``trace``: a journal as an arrival trace, and the fidelity comparison
- ``runner``: the campaign loop, a mirror of ``SaturnService._run_loop``

Entry point: ``python -m saturn_tpu_torch.analysis twin``.
"""

from saturn_tpu_torch.twin.arrivals import Arrival, arrival_stream  # noqa: F401
from saturn_tpu_torch.twin.clock import EventQueue, VirtualClock  # noqa: F401
from saturn_tpu_torch.twin.fleet import SliceSpec, VirtualFleet  # noqa: F401
