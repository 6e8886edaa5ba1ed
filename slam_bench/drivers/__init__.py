"""One module per entry of the program a cell can drive, found by name
(``registry.py``); a module whose name starts with ``_`` is shared code."""
