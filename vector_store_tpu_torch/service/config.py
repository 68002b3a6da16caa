"""Env-var driven configuration (parity with the reference's
config_manager.rs + README table): every knob is a VECTOR_STORE_* variable,
`.env` files are honored, SIGHUP re-reads them at runtime.
"""

from __future__ import annotations

import os
import re
import signal
from dataclasses import dataclass, field, fields
from typing import Callable, Optional

_DURATION_RE = re.compile(r"(?:(\d+(?:\.\d+)?)(ms|s|m|h|us))+")


def parse_duration(s: str) -> float:
    """'100ms' / '1s' / '2m' / '1h' -> seconds."""
    total = 0.0
    pos = 0
    for m in re.finditer(r"(\d+(?:\.\d+)?)(ms|us|s|m|h)", s):
        v = float(m.group(1))
        unit = m.group(2)
        total += v * {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}[unit]
        pos = m.end()
    if pos == 0:
        raise ValueError(f"invalid duration: {s}")
    return total


def load_dotenv(path: str = ".env") -> None:
    """Minimal .env support (reference loads dotenvy, main.rs:54)."""
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                os.environ.setdefault(k.strip(), v.strip().strip('"'))
    except OSError:
        pass


@dataclass
class Config:
    uri: str = "127.0.0.1:6080"
    mtls_uri: str = "127.0.0.1:6081"
    tls_cert_path: Optional[str] = None
    tls_key_path: Optional[str] = None
    mtls_ca_cert_path: Optional[str] = None
    scylladb_uri: str = "127.0.0.1:9042"
    scylladb_username: Optional[str] = None
    scylladb_password_file: Optional[str] = None
    scylladb_certificate_file: Optional[str] = None
    opensearch_uri: Optional[str] = None
    threads: Optional[int] = None
    memory_limit: Optional[int] = None
    memory_usage_check_interval: float = 1.0
    cdc_safety_interval: float = 30.0
    cdc_sleep_interval: float = 10.0
    cdc_fine_safety_interval: float = 0.1
    cdc_fine_sleep_interval: float = 0.5
    monitor_indexes_interval: float = 1.0
    index_status_update_interval: float = 1.0
    tls_file_check_interval: float = 30.0
    disable_colors: bool = False
    usearch_simulator: Optional[str] = None
    alter_index_simulator: bool = False
    # TPU-native extensions
    engine_kind: str = "auto"  # auto|flat|ivf|graph|ivf-sharded|graph-sharded
    # device count for the sharded engines' mesh (0 = every visible device)
    shards: int = 0

    @property
    def host(self) -> str:
        return self.uri.rsplit(":", 1)[0]

    @property
    def port(self) -> int:
        return int(self.uri.rsplit(":", 1)[1])

    @property
    def use_tls(self) -> bool:
        return bool(self.tls_cert_path and self.tls_key_path)


def _env(name: str) -> Optional[str]:
    return os.environ.get(f"VECTOR_STORE_{name}")


def load_config() -> Config:
    load_dotenv()
    c = Config()
    if v := _env("URI"):
        c.uri = v
    if v := _env("MTLS_URI"):
        c.mtls_uri = v
    if v := _env("TLS_CERT_PATH"):
        c.tls_cert_path = v
    if v := _env("TLS_KEY_PATH"):
        c.tls_key_path = v
    if v := _env("MTLS_CA_CERT_PATH"):
        c.mtls_ca_cert_path = v
    if v := _env("SCYLLADB_URI"):
        c.scylladb_uri = v
    if v := _env("SCYLLADB_USERNAME"):
        c.scylladb_username = v
    if v := _env("SCYLLADB_PASSWORD_FILE"):
        c.scylladb_password_file = v
    if v := _env("SCYLLADB_CERTIFICATE_FILE"):
        c.scylladb_certificate_file = v
    if v := _env("OPENSEARCH_URI"):
        c.opensearch_uri = v
    if v := _env("THREADS"):
        c.threads = int(v)
    if v := _env("MEMORY_LIMIT"):
        c.memory_limit = int(v)
    if v := _env("MEMORY_USAGE_CHECK_INTERVAL"):
        c.memory_usage_check_interval = parse_duration(v)
    if v := _env("CDC_SAFETY_INTERVAL"):
        c.cdc_safety_interval = parse_duration(v)
    if v := _env("CDC_SLEEP_INTERVAL"):
        c.cdc_sleep_interval = parse_duration(v)
    if v := _env("CDC_FINE_SAFETY_INTERVAL"):
        c.cdc_fine_safety_interval = parse_duration(v)
    if v := _env("CDC_FINE_SLEEP_INTERVAL"):
        c.cdc_fine_sleep_interval = parse_duration(v)
    if v := _env("MONITOR_INDEXES_INTERVAL"):
        c.monitor_indexes_interval = parse_duration(v)
    if v := _env("INDEX_STATUS_UPDATE_INTERVAL"):
        c.index_status_update_interval = parse_duration(v)
    if v := _env("TLS_FILE_CHECK_INTERVAL"):
        c.tls_file_check_interval = parse_duration(v)
    if v := _env("DISABLE_COLORS"):
        c.disable_colors = v.lower() == "true"
    if v := _env("USEARCH_SIMULATOR"):
        c.usearch_simulator = v
    if v := _env("ALTER_INDEX_SIMULATOR"):
        c.alter_index_simulator = v.lower() == "true"
    if v := _env("ENGINE"):
        c.engine_kind = v
    if v := _env("SHARDS"):
        c.shards = int(v)
    return c


class ConfigManager:
    """Holds the live Config and re-reads it on SIGHUP
    (config_manager.rs:254-304). Subscribers get change callbacks."""

    def __init__(self, config: Config | None = None) -> None:
        self.config = config or load_config()
        self._subscribers: list[Callable[[Config, Config], None]] = []

    def subscribe(self, fn: Callable[[Config, Config], None]) -> None:
        self._subscribers.append(fn)

    def install_sighup(self) -> None:
        try:
            signal.signal(signal.SIGHUP, lambda *_: self.reload())
        except ValueError:
            pass  # not on main thread

    def reload(self) -> None:
        old = self.config
        new = load_config()
        self.config = new
        for fn in self._subscribers:
            try:
                fn(old, new)
            except Exception:
                pass
