"""Host-side utilities of the port (the card's datasheet peaks)."""
