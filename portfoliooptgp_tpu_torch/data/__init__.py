"""CSV loading, calendar, feature transforms and the minibatch iterator."""
