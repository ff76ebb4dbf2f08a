"""Model builders: the Fig. 7 KWS spec (``kws``)."""
