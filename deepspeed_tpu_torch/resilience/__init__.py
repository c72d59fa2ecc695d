"""Resilience: the fault-injection registry (``faults``) the serving fleet's
drills arm. The rest of the JAX package's resilience layer (watchdog,
preemption, elastic reshard, the flight recorder) waits for ROADMAP A15."""
