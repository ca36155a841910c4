"""Launchers: ``spawn`` starts one process per grid point."""
