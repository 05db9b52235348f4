"""One module per traffic kind: set-up, the window's unit of work, the trace and the check."""
