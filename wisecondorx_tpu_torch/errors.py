"""Common base for user-input failures.

The reference funnels every bad-input condition through
``logging.critical`` + ``sys.exit`` (reference overall_tools.py:26-39,
main.py:99-102,143-165) so users see one-line diagnoses, never
tracebacks.  Every stage error type here derives from
:class:`UserInputError`; the CLI's central handler (cli.py:main) catches
exactly this base, keeping genuine bugs loud.

Kept dependency-free: the CLI imports it before any heavy (torch) module.
Copy of wisecondorx_tpu/errors.py; the port imports nothing of that package.
"""


class UserInputError(Exception):
    """A condition caused by user inputs/flags, not by a bug."""


class BedParseError(ValueError, UserInputError):
    """A malformed row in a user-supplied BED-ish file (blacklist /
    regions); message carries file and line number."""
