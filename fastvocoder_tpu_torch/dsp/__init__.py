"""Host-side audio I/O (numpy / scipy)."""
