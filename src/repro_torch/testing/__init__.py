"""Test-support machinery that ships with the port (not the test suite):
deterministic fault injection for crash-safety tests (``faults.py``).

Lives in the package because production modules carry the injection points
(``faults.trip`` calls at the crash-critical lines of their commit
protocols), and subprocess crash tests arm them through the environment of
a child interpreter that imports only the library."""

from . import faults  # noqa: F401
