"""Pure-Python asyncio CQL binary-protocol (v4) driver.

The reference connects to ScyllaDB through the Rust scylla driver (db.rs);
this package is its host-side replacement: framing, native-type codecs, an
asyncio connection with stream multiplexing, and a session with reconnect.
No external dependencies.
"""

from vector_store_tpu_torch.db.cql.connection import CqlConnection, CqlError
from vector_store_tpu_torch.db.cql.session import CqlSession

__all__ = ["CqlConnection", "CqlError", "CqlSession"]
