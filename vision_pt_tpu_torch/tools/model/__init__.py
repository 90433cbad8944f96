"""Weight inspection and patch-size tools of the port."""
