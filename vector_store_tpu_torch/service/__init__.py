"""Service modules that hold a device engine: the VS index actor, index
lifecycle (engine), discovery (monitor_indexes) and the memory governor.
The device-free services are reused from vector_store_tpu.service."""
