"""Offline evaluation of result dumps."""
