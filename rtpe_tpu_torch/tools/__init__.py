"""Developer tools of the port, run by hand on the card."""
