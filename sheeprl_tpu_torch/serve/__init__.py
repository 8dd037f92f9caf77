"""Policy serving (counterpart of ``sheeprl_tpu/serve``): ``python -m
sheeprl_tpu_torch.serve serve.policies=[name:selector,...]`` loads policies from the
model registry, captures one CUDA graph per bucket of a ladder of padded batch shapes
at startup, and serves observation requests over the framed-TCP transport with
continuous batching: requests wait in a bounded queue and dispatch as one padded batch
when the bucket fills or ``serve.max_batch_delay_ms`` runs out.

Importing this package is cheap: torch and the agents load when a server starts
(``serve/server.py``). Not ported yet: the serving fleet (``serve/fleet``,
``FleetClient``) and the serve bench.
"""

from sheeprl_tpu_torch.serve.router import parse_spec, resolve_version

__all__ = ["parse_spec", "resolve_version"]
