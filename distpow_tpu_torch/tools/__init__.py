"""Measurement scripts run on the card by hand; nothing on the search path
imports them."""
