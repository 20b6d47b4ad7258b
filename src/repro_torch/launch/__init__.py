"""Launchers: the ingest and serve command lines over the layout service."""
