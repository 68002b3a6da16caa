"""Service modules that hold a device engine: the VS index actor, index
lifecycle (engine), discovery (monitor_indexes) and the memory governor.
The device-free services are copies of vector_store_tpu.service's
(config, indexes, internals, metrics, node_state, worker, monitor_items,
file_monitor, fts_index)."""
