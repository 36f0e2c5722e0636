"""MLProxy core — copies of the JAX package's numpy/stdlib control plane.

The modules here are verbatim copies of ``core/`` in the JAX package,
with only their imports pointed at this package, so the port imports
nothing of it: the queue layer (``BatchQueue``, ``Policy``), the policy
layer (``MLProxy`` and the baselines of ``core/policies.py``) and the
routing layer (``ProxyFrontend``). :mod:`repro_torch.core.fleet_controller`
holds the fleet-scale vectorised controller, the port of the JAX
package's ``core/jax_controller.py`` on torch tensors.
"""
from repro_torch.core import fleet_controller  # noqa: F401
from repro_torch.core.batch_queue import BatchQueue, Policy  # noqa: F401
from repro_torch.core.config import (  # noqa: F401
    MonitorConfig,
    OptimizerConfig,
    ProxyConfig,
    SLAConfig,
    bucket_of,
    ms,
)
from repro_torch.core.frontend import Endpoint, ProxyFrontend  # noqa: F401
from repro_torch.core.monitor import LatencyWindow, P2Quantile, SmartMonitor  # noqa: F401
from repro_torch.core.optimizer import AIMDBatchOptimizer  # noqa: F401
from repro_torch.core.proxy import MLProxy  # noqa: F401
from repro_torch.core.request import Batch, Request  # noqa: F401
from repro_torch.core.scheduler import QueueScheduler  # noqa: F401
