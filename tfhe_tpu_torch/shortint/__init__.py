"""Shortint layer of the port: client key, server key, LUTs."""

from .ciphertext import (LookupTable, ManyLookupTable,  # noqa: F401
                         ShortintCiphertext)
from .client_key import ClientKey  # noqa: F401
from .server_key import ServerKey  # noqa: F401
