"""LSP client side: a reliable, ordered, connection-oriented message
protocol over UDP.

Counterpart of ``tpuminter.lsp``, reduced to what a worker dials with:
the client, its connection state machine, the UDP endpoint, the frame
codec with its CRC, and the ``Params``/``FAST`` settings. The server
side stays in the JAX package's control plane, which the port talks to
over the wire only.
"""

from tpuminter_torch.lsp.client import (
    LspClient,
    LspConnectError,
    LspConnectionLost,
    LspError,
)
from tpuminter_torch.lsp.params import FAST, Params

__all__ = [
    "FAST",
    "LspClient",
    "LspConnectError",
    "LspConnectionLost",
    "LspError",
    "Params",
]
