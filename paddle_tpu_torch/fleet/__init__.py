"""Fleet tier: a resilient router/front over N serving-engine replicas.

The port of paddle_tpu/fleet: the tier above one engine, which survives
a replica dying mid-stream.

- `replica` — the one backend interface (`Replica`) with two
  implementations: `InProcessReplica` (an engine in this process, health
  read straight off its internals) and `HTTPReplica` (a remote
  `serving/http.py` front, health probed via the /livez-vs-/healthz
  split, streams consumed as chunked JSONL).
- `router` — `FleetRouter`: replica registry with circuit-breakered
  health probes and consecutive-miss death declaration, prefix-affinity
  / session-sticky / least-loaded routing, cross-replica admission
  shedding, failover replay with stream splicing (proven by the replay
  replica's own token count), and drain-aware rolling restarts. Every
  decision is a typed `kind=fleet` record.
- `http` — `FleetHTTPServer`: the fleet's own /generate front with
  failover built in, plus /metrics (fleet.* gauges), /healthz, /livez,
  /replicas.
- `drill` — `python -m paddle_tpu_torch.fleet.drill`: replica
  processes on one card, a SIGKILL mid-stream, a respawn and a rolling
  restart under load, the combined ledger checked by
  telemetry/ledger_check.py.
"""
from .replica import HTTPReplica, InProcessReplica, Replica  # noqa: F401
from .router import FleetRouter, FleetShedError, NoHealthyReplicaError  # noqa: F401

__all__ = ["Replica", "InProcessReplica", "HTTPReplica", "FleetRouter",
           "FleetShedError", "NoHealthyReplicaError", "FleetHTTPServer"]


def __getattr__(name):
    if name == "FleetHTTPServer":     # lazy: pulls in http.server
        from .http import FleetHTTPServer
        return FleetHTTPServer
    raise AttributeError(f"module 'paddle_tpu_torch.fleet' has no "
                         f"attribute {name!r}")
