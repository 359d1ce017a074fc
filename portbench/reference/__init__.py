"""The plain reference that decides ``correct``: the search's plan and the
spectrum of any (DM, acceleration) trial worked out again from the
observation's header, its bytes and the search's flags, in plain numpy
and torch. It imports nothing of the port and takes nothing the port
made; it reads the port's candidates only to judge them."""
