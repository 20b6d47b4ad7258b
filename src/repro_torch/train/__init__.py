"""Serving steps of the LM stack; training comes in a later slice."""
