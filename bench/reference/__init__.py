"""Plain references the benchmark holds the program to; a configuration
names its reference module here (``"reference"`` in its file)."""
