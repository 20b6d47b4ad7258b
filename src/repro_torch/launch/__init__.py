"""Launchers: the ingest and serve command lines over the layout service,
and the LM serving command line (``serve_lm``)."""
