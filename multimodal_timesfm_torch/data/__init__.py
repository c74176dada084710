"""Host-side data staging."""
