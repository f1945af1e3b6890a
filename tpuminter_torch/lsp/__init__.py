"""LSP: a reliable, ordered, connection-oriented message protocol over
UDP.

Counterpart of ``tpuminter.lsp``: the client and the multi-client
server, their shared connection state machine, the UDP endpoint with
its fault-injection seam, the frame codec with its CRC, the
``Params``/``FAST`` settings, and the echo runners ``srunner`` and
``crunner``. The wire is the reference's byte for byte, so either side
talks to the reference's other side.
"""

from tpuminter_torch.lsp.client import (
    LspClient,
    LspConnectError,
    LspConnectionLost,
    LspError,
)
from tpuminter_torch.lsp.params import FAST, Params
from tpuminter_torch.lsp.server import LspServer

__all__ = [
    "FAST",
    "LspClient",
    "LspConnectError",
    "LspConnectionLost",
    "LspError",
    "LspServer",
    "Params",
]
