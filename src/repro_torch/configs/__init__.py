"""Architecture configs of the LM substrate (``get_arch``)."""
