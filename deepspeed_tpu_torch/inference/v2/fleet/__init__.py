"""Serving fleet: SLO-aware admission routing + prefill/decode
disaggregation over shipped KV pages (port of
``deepspeed_tpu/inference/v2/fleet``).

The layer above a single ``ReplicaGroup`` (the DeepSpeed-MII load-balancer
analog): ``SLORouter`` places by least predicted TTFT with prefix-digest
affinity and sheds or queues with typed outcomes; ``PrefillDecodeFleet``
specializes replicas so prefill never competes with decode for a token
budget, shipping finished KV pages between replicas through
``KVPageTransport`` (the device codec, or the serialized ``wire`` codec
with delta shipping and ``FlowControl``); ``two_process`` runs the decode
side in a separate OS process over the same frames. The elasticity layer
(``lifecycle``) makes the fleet chaos-tolerant: the replica lifecycle state
machine, missed-heartbeat failure detection, bit-exact re-admission after
replica loss, and the saturation-driven ``FleetAutoscaler``.
"""

# lifecycle first: disagg imports it, and it must not round-trip through
# this package (circular import otherwise)
from deepspeed_tpu_torch.inference.v2.fleet.lifecycle import (  # noqa: F401
    DEAD, DRAINING, LIVE, FailureDetector, FleetAutoscaler,
    ReplicaLifecycle)
from deepspeed_tpu_torch.inference.v2.fleet.router import (  # noqa: F401
    RequestAdmitted, RequestQueued, RequestRejected, SLORouter)
from deepspeed_tpu_torch.inference.v2.fleet.disagg import (  # noqa: F401
    FlowControl, HandoffError, KVPageTransport, PrefillDecodeFleet)
