"""Runtime layer of the port (``repro.runtime``): compile cache,
checkpointing and the MPG-instrumented training orchestrator."""
