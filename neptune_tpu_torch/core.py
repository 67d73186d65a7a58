"""Reference-parity alias: `neptune.core` exposed `GlobalContext` and
`get_compiler`; user scripts call `core.get_compiler().dump()`."""

from .frontend.core import (  # noqa: F401
    Context,
    GlobalContext,
    get_compiler,
    get_context,
    reset_context,
)
