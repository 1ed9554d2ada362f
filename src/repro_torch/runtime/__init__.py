"""Asynchronous master-worker coded execution engine with layered fusion.

The measured counterpart of ``repro_torch.core.simulator``: real coded
matmul tasks on concurrent workers, any-k fusion per MSB-first round,
purge of stale tasks, and §IV deadline termination releasing the highest
completed resolution.  Results come back in the simulator's ``SimResult``
shape so measured runs validate directly against ``simulate()`` and
``theory_bounds()``.

Workers compute on a CUDA device by default (``backend="cuda"``);
``backend="thread"`` runs them on host BLAS.

Quickstart::

    from repro_torch.runtime import RuntimeConfig, run_jobs

    cfg = RuntimeConfig(mu=(400.0, 650.0, 380.0), arrival_rate=30.0,
                        complexity=2.0, deadline=0.05, straggler="exp")
    result, futures = run_jobs(cfg, num_jobs=50, verify=True)
    print(result.mean_delay(), result.success_rate())
"""

from repro_torch.runtime.adaptive import (POLICIES, AIMDPolicy,
                                          DeadlineMarginPolicy, FixedPolicy,
                                          OmegaController, OmegaPolicy,
                                          RoundObservation, margin_ratio)
from repro_torch.runtime.errors import FusionStateError, TransportDeadError
from repro_torch.runtime.faults import FaultSupervisor
from repro_torch.runtime.fusion import FusionNode, LayeredResult, RoundFusion
from repro_torch.runtime.gateway import (AdmissionController, GatewayStats,
                                         ServingGateway, Ticket)
from repro_torch.runtime.master import JobQueue, Master, make_jobs, run_jobs
from repro_torch.runtime.metrics import (STAGES, RuntimeResult, delay_table,
                                         format_controller_trace,
                                         format_delay_table,
                                         format_stage_table)
from repro_torch.runtime.tasks import (BACKEND_NAMES, CODE_FAMILIES,
                                       FAULT_POLICIES, FRAME_PROTOS,
                                       SHM_MODES, JobSpec, RoundBatch,
                                       RoundContext, RuntimeConfig,
                                       TaskResult, WireBatch)
from repro_torch.runtime.telemetry import TraceEvent, Tracer
from repro_torch.runtime.trace_export import (chrome_trace, format_timeline,
                                              jsonl_lines,
                                              prometheus_snapshot,
                                              write_chrome_trace,
                                              write_jsonl)
# The concrete backend classes (ThreadTransport / ProcessTransport /
# CudaDeviceTransport / SocketTransport) are reached via
# `repro_torch.runtime.transport.<Name>` (lazy, PEP 562) or
# `BACKENDS[name]`, so importing the runtime builds no backend.
from repro_torch.runtime.transport import (BACKENDS, WorkerTransport,
                                           make_transport)
from repro_torch.runtime.worker import (BatchRunner, StragglerModel, Worker,
                                        WorkerPool, make_compute)

__all__ = [
    "RuntimeConfig", "JobSpec", "RoundContext", "RoundBatch", "TaskResult",
    "WireBatch", "BACKEND_NAMES", "FAULT_POLICIES", "SHM_MODES",
    "FRAME_PROTOS", "CODE_FAMILIES",
    "FaultSupervisor", "TransportDeadError", "FusionStateError",
    "Worker", "WorkerPool", "StragglerModel", "BatchRunner", "make_compute",
    "WorkerTransport", "BACKENDS", "make_transport",
    "FusionNode", "RoundFusion", "LayeredResult",
    "Master", "JobQueue", "make_jobs", "run_jobs",
    "ServingGateway", "AdmissionController", "GatewayStats", "Ticket",
    "OmegaController", "OmegaPolicy", "RoundObservation", "POLICIES",
    "FixedPolicy", "AIMDPolicy", "DeadlineMarginPolicy", "margin_ratio",
    "RuntimeResult", "delay_table", "format_delay_table",
    "format_stage_table", "format_controller_trace", "STAGES",
    "Tracer", "TraceEvent", "chrome_trace", "write_chrome_trace",
    "jsonl_lines", "write_jsonl", "prometheus_snapshot", "format_timeline",
]
