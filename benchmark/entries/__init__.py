"""Entries: how a traffic mix hands frames to the program, one module per
entry of the port, found by the traffic file's ``entry``."""
