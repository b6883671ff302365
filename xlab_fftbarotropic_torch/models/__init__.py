"""Model families ported so far: barotropic vorticity."""
