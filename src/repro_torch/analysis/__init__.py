"""Analysis of the port's LM steps: the roofline on one H100 (:mod:`.roofline`)."""
