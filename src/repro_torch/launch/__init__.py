"""Launchers: the ingest and serve command lines over the layout service,
and the LM serving and training command lines (``serve_lm``, ``train``)."""
