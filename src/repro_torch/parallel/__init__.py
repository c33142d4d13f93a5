"""Box work-queue ordering."""
