"""One-card launch tools (port of `repro.launch`): the dry run's plan on
the ``meta`` device and its run on the card (`dryrun`), the H100 roofline
(`roofline`), their tables (`report`) and the card's record (`mesh`)."""
