"""Pure-Python utilities: typed configuration and fit profiles."""
