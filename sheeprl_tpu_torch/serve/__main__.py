"""``python -m sheeprl_tpu_torch.serve``: run one policy-server replica (counterpart of
``sheeprl_tpu/serve/__main__.py``). Overrides use the training entry's grammar::

    python -m sheeprl_tpu_torch.serve serve.policies='[cartpole_ppo:latest]' \\
        model_manager.registry_dir=models_registry serve.port=7557 serve.max_batch_size=32 \\
        [serve.precision=f32|bf16|int8] [serve.ready_file=ready.json] [device=cpu]

Composes the ``serve_cli`` root config (serve, model_manager, analysis and fault
groups), installs the SIGTERM/SIGINT handlers, serves on ``device`` (``cuda`` unless
``device=cpu``; without CUDA it raises) and exits with the server's code: 75
(``RESUMABLE_EXIT_CODE``) after a preemption drain.
"""

from __future__ import annotations

import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    overrides = list(sys.argv[1:] if argv is None else argv)
    from sheeprl_tpu_torch.config.core import compose

    cfg = compose(config_name="serve_cli", overrides=overrides)

    from sheeprl_tpu_torch.fault.preemption import install_signal_handlers

    install_signal_handlers(grace_seconds=float((cfg.get("fault") or {}).get("grace_seconds", 0) or 0))

    from sheeprl_tpu_torch.serve.server import PolicyServer

    return PolicyServer(cfg).run()


if __name__ == "__main__":
    sys.exit(main())
