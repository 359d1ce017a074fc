"""Helpers of the port's tools: :mod:`.parsers` reads overview.xml."""
