"""Language clients over the shared native tb_client runtime.

reference: src/clients/ — every language binding is a thin wrapper over the
C-ABI tb_client (src/clients/c/tb_client.zig). Here: the C ABI lives in
csrc/tb_client.cpp (a copy of the JAX package's native/tb_client.cpp),
`clients.c_client.CClient` is the Python binding over it and
`vsr.client.Client` the pure-Python alternative; both share the typed
request encoding of common.py. `clients.codegen` generates the Go, Node,
Java, .NET, Ruby and Rust packages under the repo's clients/.
"""

from .c_client import CClient, c_client_available

__all__ = ["CClient", "c_client_available"]
