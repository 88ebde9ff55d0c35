"""Host-side fault tolerance of long training runs."""
